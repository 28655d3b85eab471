"""Acoustic runtime: bucket-padded encoder forwards on the device.

Port of tilawa_tpu/pipeline/runtime.py EncoderRuntime, with the same
duck-typed contract the Recognizer uses: forward, forward_batch,
forward_batch_async, log_probs, log_probs_batch, blank_id. Audio lengths
are padded to the same AUDIO_BUCKETS ladder. forward_batch_async uploads
int16 PCM and rescales on the device, as the JAX predict path does, pads the
log-probs to a rerank frame bucket and takes the argmax on the device; the
log-probs stay there for the CTC rerank and only the id matrix crosses to
the host.

Not ported yet (streaming slice): long_chunking / forward_long and
StreamingEncoderCache.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tilawa_tpu_torch.device import resolve_device
from tilawa_tpu_torch.models.convert import load_into
from tilawa_tpu_torch.models.fastconformer import FastConformerConfig, FastConformerCTC
from tilawa_tpu_torch.ops.ctc import FRAME_BUCKETS, _next_bucket

# Audio-sample bucket ladder: 4s to 120s at 16 kHz, power-of-two steps.
AUDIO_BUCKETS = (64000, 128000, 256000, 512000, 1024000, 1920000)
# Clips past this many samples take per-variant TTA forwards (predict.py).
LONG_THRESHOLD = 256000


def bucket_length(n: int, buckets: tuple[int, ...] = AUDIO_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1])) * buckets[-1]


class EncoderRuntime:
    """FastConformer forward on `device` with audio-length bucketing.
    `forwards` counts the batched encoder passes run."""

    def __init__(
        self,
        config: FastConformerConfig,
        variables: dict,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
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

    @torch.inference_mode()
    def forward_batch_async(self, audios: list[np.ndarray]):
        """Queue a batched forward without synchronizing: returns
        (lp [B, T_bucket, V] on the device, packed [B, 1 + T_bucket] int32
        on the device, column 0 the encoder frame counts, the rest the
        per-frame argmax ids)."""
        n_pad = bucket_length(max(len(a) for a in audios))
        batch = np.zeros((len(audios), n_pad), dtype=np.int16)
        lengths = np.zeros(len(audios), dtype=np.int32)
        for i, a in enumerate(audios):
            batch[i, : len(a)] = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
            lengths[i] = len(a)
        audio = torch.from_numpy(batch).to(self.device).to(torch.float32) / 32768.0
        lp, enc_lens = self._apply(audio, torch.from_numpy(lengths).to(self.device))
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
        np.int32, t_valid int)."""
        lp, lens, ids = self.forward_batch([audio])
        t_valid = int(lens[0])
        return lp[0], ids[0, :t_valid], t_valid
