"""Compact token trie over verse/span token sequences.

The reference builds a flat-array prefix trie over per-verse phoneme token
ids (~1.7M nodes ≈ 20 MB) so CTC beam search can be constrained to real
Quran prefixes (reference: web/frontend/src/lib/phoneme-trie.ts:53-59).
This is the framework-side equivalent: CSR edge arrays + CSR terminal-ref
lists, generic over any token id space (69-phoneme or 1025-BPE).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class TokenTrie:
    """Frozen CSR trie. Node 0 is the root.

    edge_start[n]/edge_count[n] index into edge_token/edge_child;
    end_start[n]/end_count[n] index into end_refs (verse refs that
    terminate exactly at node n)."""

    def __init__(self, edge_start, edge_count, edge_token, edge_child,
                 end_start, end_count, end_refs):
        self.edge_start = edge_start
        self.edge_count = edge_count
        self.edge_token = edge_token
        self.edge_child = edge_child
        self.end_start = end_start
        self.end_count = end_count
        self.end_refs = end_refs

    @property
    def num_nodes(self) -> int:
        return len(self.edge_start)

    @property
    def num_edges(self) -> int:
        return len(self.edge_token)

    @classmethod
    def build(
        cls, sequences: Iterable[tuple[Sequence[int], tuple]]
    ) -> "TokenTrie":
        """sequences: (token_ids, ref) pairs; ref is any hashable payload
        (e.g. (surah, ayah, ayah_end))."""
        children: list[dict[int, int]] = [{}]
        ends: list[list] = [[]]

        for ids, ref in sequences:
            node = 0
            for tok in ids:
                nxt = children[node].get(tok)
                if nxt is None:
                    nxt = len(children)
                    children[node][tok] = nxt
                    children.append({})
                    ends.append([])
                node = nxt
            ends[node].append(ref)

        n = len(children)
        edge_count = np.fromiter(
            (len(c) for c in children), dtype=np.int32, count=n
        )
        edge_start = np.zeros(n, dtype=np.int64)
        np.cumsum(edge_count[:-1], out=edge_start[1:])
        total_edges = int(edge_count.sum())
        edge_token = np.empty(total_edges, dtype=np.int32)
        edge_child = np.empty(total_edges, dtype=np.int64)
        pos = 0
        for c in children:
            for tok in sorted(c):
                edge_token[pos] = tok
                edge_child[pos] = c[tok]
                pos += 1

        end_count = np.fromiter((len(e) for e in ends), dtype=np.int32, count=n)
        end_start = np.zeros(n, dtype=np.int64)
        np.cumsum(end_count[:-1], out=end_start[1:])
        end_refs: list = []
        for e in ends:
            end_refs.extend(e)
        return cls(edge_start, edge_count, edge_token, edge_child,
                   end_start, end_count, end_refs)

    # -------------------------------------------------------------- queries

    def children(self, node: int) -> tuple[np.ndarray, np.ndarray]:
        s, c = int(self.edge_start[node]), int(self.edge_count[node])
        return self.edge_token[s:s + c], self.edge_child[s:s + c]

    def child(self, node: int, token: int) -> int | None:
        toks, kids = self.children(node)
        i = int(np.searchsorted(toks, token))
        if i < len(toks) and toks[i] == token:
            return int(kids[i])
        return None

    def refs_at(self, node: int) -> list:
        s, c = int(self.end_start[node]), int(self.end_count[node])
        return self.end_refs[s:s + c]

    def is_terminal(self, node: int) -> bool:
        return int(self.end_count[node]) > 0

    def walk(self, ids: Sequence[int]) -> int | None:
        node = 0
        for tok in ids:
            node = self.child(node, int(tok))
            if node is None:
                return None
        return node

    def memory_bytes(self) -> int:
        return (
            self.edge_start.nbytes + self.edge_count.nbytes
            + self.edge_token.nbytes + self.edge_child.nbytes
            + self.end_start.nbytes + self.end_count.nbytes
        )


def build_verse_trie(store, tok_to_id: dict | None = None) -> TokenTrie:
    """Trie over all 6,236 verses' phoneme token ids from a PhonemeStore."""
    lookup = tok_to_id or {t: i for i, t in enumerate(store.vocab)}

    def gen():
        for (surah, ayah), phonemes in store.refs.items():
            ids = [lookup[t] for t in phonemes.split() if t in lookup]
            if ids:
                yield ids, (surah, ayah, None)

    return TokenTrie.build(gen())
