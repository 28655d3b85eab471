"""Acoustic runtime: bucket-padded encoder forwards on the device.

Port of tilawa_tpu/pipeline/runtime.py, with the same duck-typed contract
the Recognizer and the streaming tracker use: forward, forward_batch,
forward_batch_async, forward_long, log_probs, log_probs_batch, blank_id.
Audio lengths are padded to the same AUDIO_BUCKETS ladder. The decode paths
upload int16 PCM and rescale on the device, as the JAX package does, pad
the log-probs to a rerank frame bucket and take the argmax on the device;
the log-probs stay there for the CTC scorers and only the ids (with the
frame count) cross to the host, in one copy.

Long clips (long_chunking=True, or the streaming cache) run as one
[K, LONG_CHUNK] batch of overlapping 16 s windows whose log-probs are
stitched on the device with _JUNCTION_TRIM frames cut from each side of
every junction. StreamingEncoderCache keys each full window by the sha1 of
its samples, so a growing streaming window re-forwards only its tail.
OracleRuntime renders CTC log-probs from token ids (numpy only).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from tilawa_tpu_torch.data.assets import BLANK_ID
from tilawa_tpu_torch.device import resolve_device
from tilawa_tpu_torch.models.convert import load_into
from tilawa_tpu_torch.models.fastconformer import FastConformerConfig, FastConformerCTC
from tilawa_tpu_torch.ops.ctc import FRAME_BUCKETS, _next_bucket

# Audio-sample bucket ladder: 4s to 120s at 16 kHz, power-of-two steps.
AUDIO_BUCKETS = (64000, 128000, 256000, 512000, 1024000, 1920000)

# Long-clip chunking: clips past LONG_THRESHOLD run as one batched
# [K, LONG_CHUNK] forward of overlapping windows, stitched on the device.
# It also sets where the Recognizer's TTA turns to per-variant forwards.
LONG_CHUNK = 256000        # 16 s
LONG_OVERLAP = 16000       # 1 s
LONG_STEP = LONG_CHUNK - LONG_OVERLAP
LONG_THRESHOLD = LONG_CHUNK
# encoder frames trimmed per junction side: ~12.5 overlap frames / 2
_JUNCTION_TRIM = 6


def bucket_length(n: int, buckets: tuple[int, ...] = AUDIO_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1])) * buckets[-1]


def _pcm16(piece: np.ndarray) -> np.ndarray:
    return np.clip(piece * 32768.0, -32768, 32767).astype(np.int16)


def _stitch(chunks: list[torch.Tensor], last_enc_len: torch.Tensor):
    """K chunk log-probs [Tc, V] → (lp [T_bucket, V], t_valid as a 0-d
    tensor, ids [T_bucket] int32), all on the chunks' device: the first
    chunk loses its last _JUNCTION_TRIM frames, the last its first, the
    middle ones both; the result is padded to a rerank frame bucket."""
    k, trim = len(chunks), _JUNCTION_TRIM
    tc = chunks[0].shape[0]
    parts = [chunks[0][: tc - trim]]
    parts += [c[trim : tc - trim] for c in chunks[1:-1]]
    parts.append(chunks[-1][trim:])
    out = torch.cat(parts, dim=0)
    t_total = out.shape[0]
    t_pad = _next_bucket(t_total, FRAME_BUCKETS)
    if t_pad != t_total:
        out = F.pad(out, (0, 0, 0, t_pad - t_total))
    t_valid = (tc - trim) + (k - 2) * (tc - 2 * trim) + torch.clamp(last_enc_len - trim, min=0)
    ids = torch.argmax(out, dim=-1).to(torch.int32)
    return out, torch.clamp(t_valid, max=t_total), ids


def _fetch_ids(t_valid: torch.Tensor, ids: torch.Tensor) -> tuple[np.ndarray, int]:
    """One device-to-host copy of the frame count and the ids."""
    packed = torch.cat([t_valid.reshape(1).to(torch.int32), ids]).cpu().numpy()
    t = int(packed[0])
    return packed[1 : 1 + t], t


class EncoderRuntime:
    """FastConformer forward on `device` with audio-length bucketing.
    `forwards` counts the batched encoder passes run.

    long_chunking=True routes clips past LONG_THRESHOLD through the chunked
    stitched forward (forward_long). Off by default, as in the JAX package:
    models trained on full utterances decode partial windows badly; the
    streaming cache always chunks, since its windows are partial anyway."""

    def __init__(
        self,
        config: FastConformerConfig,
        variables: dict,
        device: str | torch.device = "cuda",
        long_chunking: bool = False,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.long_chunking = long_chunking
        self.variables = variables
        self.model = load_into(FastConformerCTC(config), variables).to(self.device).eval()
        self.forwards = 0

    @property
    def blank_id(self) -> int:
        return self.config.blank_id

    @torch.inference_mode()
    def _apply(self, audio: torch.Tensor, lengths: torch.Tensor):
        self.forwards += 1
        return self.model(audio, lengths)

    def log_probs(self, audio: np.ndarray) -> tuple[np.ndarray, int]:
        """[N] waveform → ([T, V] log-probs, valid frame count)."""
        lp, lens = self.log_probs_batch([audio])
        return lp[0], int(lens[0])

    def log_probs_batch(
        self, audios: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Variable-length batch → ([B, T_pad, V] log-probs, [B] frame counts),
        f32 audio padded to one shared bucket."""
        n_pad = bucket_length(max(len(a) for a in audios))
        batch = np.zeros((len(audios), n_pad), dtype=np.float32)
        lengths = np.zeros(len(audios), dtype=np.int32)
        for i, a in enumerate(audios):
            batch[i, : len(a)] = a
            lengths[i] = len(a)
        lp, enc_lens = self._apply(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        return lp.cpu().numpy(), enc_lens.cpu().numpy()

    def _apply_pcm16(self, pieces: list[np.ndarray], n_pad: int, rows: int):
        """Forward of `pieces` as int16 PCM in a [rows, n_pad] batch (zero
        rows past the pieces), rescaled to f32 on the device."""
        batch = np.zeros((rows, n_pad), dtype=np.int16)
        lengths = np.zeros(rows, dtype=np.int32)
        for i, a in enumerate(pieces):
            batch[i, : len(a)] = _pcm16(a)
            lengths[i] = len(a)
        audio = torch.from_numpy(batch).to(self.device).to(torch.float32) / 32768.0
        return self._apply(audio, torch.from_numpy(lengths).to(self.device))

    @staticmethod
    def chunk_count(n_samples: int) -> int:
        """Number of LONG_CHUNK windows covering n_samples (>= 2 when the
        clip exceeds LONG_THRESHOLD)."""
        if n_samples <= LONG_THRESHOLD:
            return 1
        k = 1
        while (k - 1) * LONG_STEP + LONG_CHUNK < n_samples:
            k += 1
        return k

    @torch.inference_mode()
    def forward_long(self, audio: np.ndarray):
        """Chunked forward: one [K, LONG_CHUNK] batch, junction-trimmed
        stitch on the device. Same contract as forward():
        (lp [T_bucket, V] on the device, ids np [t_valid], t_valid)."""
        k = self.chunk_count(len(audio))
        pieces = [audio[i * LONG_STEP : i * LONG_STEP + LONG_CHUNK] for i in range(k)]
        lp, enc_lens = self._apply_pcm16(pieces, LONG_CHUNK, k)
        out, t_valid, ids = _stitch(list(lp), enc_lens[k - 1])
        ids_np, t = _fetch_ids(t_valid, ids)
        return out, ids_np, t

    @torch.inference_mode()
    def forward_batch_async(self, audios: list[np.ndarray]):
        """Queue a batched forward without synchronizing: returns
        (lp [B, T_bucket, V] on the device, packed [B, 1 + T_bucket] int32
        on the device, column 0 the encoder frame counts, the rest the
        per-frame argmax ids)."""
        n_pad = bucket_length(max(len(a) for a in audios))
        lp, enc_lens = self._apply_pcm16(audios, n_pad, len(audios))
        t = lp.shape[1]
        t_pad = _next_bucket(t, FRAME_BUCKETS)
        if t_pad != t:
            lp = F.pad(lp, (0, 0, 0, t_pad - t))
        ids = torch.argmax(lp, dim=-1).to(torch.int32)
        packed = torch.cat([enc_lens.to(torch.int32)[:, None], ids], dim=1)
        return lp, packed

    def forward_batch(self, audios: list[np.ndarray]):
        """Batched forward: (lp on the device [B, T_bucket, V], enc_lens np
        [B], ids np [B, T_bucket])."""
        lp, packed = self.forward_batch_async(audios)
        packed = packed.cpu().numpy()
        return lp, packed[:, 0], packed[:, 1:]

    def forward(self, audio: np.ndarray):
        """[N] waveform → (lp [T_bucket, V] on the device, ids [T_enc]
        np.int32, t_valid int). With long_chunking, clips past
        LONG_THRESHOLD take the chunked stitched forward."""
        if self.long_chunking and len(audio) > LONG_THRESHOLD:
            return self.forward_long(audio)
        lp, lens, ids = self.forward_batch([audio])
        t_valid = int(lens[0])
        return lp[0], ids[0, :t_valid], t_valid


class StreamingEncoderCache:
    """Content-addressed per-chunk encoder cache for rolling windows.

    The streaming tracker re-forwards its whole discovery window every
    cycle; past LONG_THRESHOLD most of that window is byte-identical to the
    previous cycle's. Each full LONG_CHUNK window is keyed by the sha1 of
    its samples and its log-probs stay on the device, so a cycle forwards
    only the windows it has not seen (steady state: the growing tail) in a
    batch padded to {1, 2, 4, 8} rows, then stitches as forward_long does.
    The upload is int16 PCM, as forward_long's, so both see the same audio.
    """

    MAX_ENTRIES = 24

    def __init__(self, runtime: EncoderRuntime):
        self.runtime = runtime
        self._cache: dict[bytes, torch.Tensor] = {}   # chunk sha1 -> lp [Tc, V]
        self.hits = 0
        self.misses = 0

    @torch.inference_mode()
    def forward(self, audio: np.ndarray):
        """Same contract as EncoderRuntime.forward, with chunk caching."""
        rt = self.runtime
        n = len(audio)
        if n <= LONG_THRESHOLD:
            return rt.forward(audio)
        k = rt.chunk_count(n)

        chunk_lps: list[torch.Tensor | None] = []
        to_run: list[tuple[int, bytes, np.ndarray]] = []
        for i in range(k):
            piece = audio[i * LONG_STEP : i * LONG_STEP + LONG_CHUNK]
            if i < k - 1:
                key = _chunk_key(piece)
                hit = self._cache.get(key)
                if hit is not None:
                    self.hits += 1
                    chunk_lps.append(hit)
                    continue
                self.misses += 1
                to_run.append((i, key, piece))
            else:
                to_run.append((i, b"", piece))
            chunk_lps.append(None)

        b_pad = 1
        while b_pad < len(to_run):
            b_pad *= 2
        lp_new, enc_lens = rt._apply_pcm16([p for _i, _k, p in to_run], LONG_CHUNK, b_pad)
        for j, (i, key, _piece) in enumerate(to_run):
            chunk_lps[i] = lp_new[j]
            if i < k - 1:
                self._cache[key] = lp_new[j]
        last_enc_len = enc_lens[len(to_run) - 1]
        while len(self._cache) > self.MAX_ENTRIES:
            self._cache.pop(next(iter(self._cache)))

        out, t_valid, ids = _stitch(chunk_lps, last_enc_len)
        ids_np, t = _fetch_ids(t_valid, ids)
        return out, ids_np, t


def _chunk_key(piece: np.ndarray) -> bytes:
    return hashlib.sha1(piece.tobytes()).digest()


class OracleRuntime:
    """Synthetic acoustic backend: ground-truth token ids → CTC log-probs
    (numpy; copied from the JAX package).

    Emission model per frame: the scheduled symbol gets probability mass
    (1 - noise), the rest is spread over a random alternative and blank.
    `error_rate` replaces a fraction of emitted tokens with lexical
    neighbors, simulating ASR substitutions; `frames_per_token` paces the
    emission like ~12.5 fps FastConformer output.
    """

    def __init__(
        self,
        token_lookup,
        blank_id: int = BLANK_ID,
        vocab_size: int = BLANK_ID + 1,
        frames_per_token: int = 3,
        noise: float = 0.15,
        error_rate: float = 0.0,
        seed: int = 0,
    ):
        self._lookup = token_lookup  # (surah, ayah, ayah_end) -> list[int]
        self.blank_id = blank_id
        self.vocab_size = vocab_size
        self.frames_per_token = frames_per_token
        self.noise = noise
        self.error_rate = error_rate
        self._rng = np.random.default_rng(seed)

    def render(self, refs: list[tuple[int, int, int | None]]) -> tuple[np.ndarray, int]:
        """Render log-probs for a recitation of the given verse refs."""
        ids: list[int] = []
        for surah, ayah, ayah_end in refs:
            ids.extend(self._lookup(surah, ayah, ayah_end))
        return self.render_ids(ids)

    def render_ids(self, ids: list[int]) -> tuple[np.ndarray, int]:
        """Render log-probs for an explicit token-id sequence."""
        if self.error_rate > 0:
            ids = [
                int(self._rng.integers(0, self.vocab_size - 1))
                if self._rng.random() < self.error_rate else i
                for i in ids
            ]
        t = max(len(ids) * self.frames_per_token + 8, 16)
        lp = np.full((t, self.vocab_size), -20.0, dtype=np.float32)
        frame = 0
        for tok in ids:
            # blank lead-in then the token
            for _ in range(self.frames_per_token - 1):
                lp[frame, self.blank_id] = 0.0
                frame += 1
            lp[frame, tok] = 0.0
            frame += 1
        while frame < t:
            lp[frame, self.blank_id] = 0.0
            frame += 1
        if self.noise > 0:
            jitter = self._rng.normal(0.0, self.noise, size=lp.shape).astype(np.float32)
            lp = lp + jitter
        # renormalize to proper log-probs
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        return lp.astype(np.float32), t
