"""Continuous-batching serving engine with an Uruv page/prefix table.

A port of the JAX package's ``repro.serve.engine``.  The engine keeps
slot-based contiguous KV caches ([L, n_slots, KVH, max_len, hd]) and
uses the paper's store for the two shared indexes a real engine needs:

  * prefix cache — key = rolling hash of a prompt prefix; value packs
    (slot, length).  Admission SEARCHes the longest cached prefix and
    copies the donor slot's KV; completed prompts INSERT their prefixes.
  * sequence table — the scheduler's SNAPSHOT + RANGEQUERY
    (:meth:`Engine.snapshot_view`) sees a consistent view of the table
    while admissions keep mutating it.

A cold admission is one ``transformer.prefill`` (the flash-attention
kernel on the card); a reused prefix is copied and the rest of the prompt
fed step by step; each tick is one ``decode_step`` over all slots (the
decode-attention kernel).  The table is a port ``Uruv`` under the
default self-sizing policy, driven through the port's ``Coalescer``.
Everything runs on ``device`` (default ``cuda``; ``device="cpu"`` for
the plain PyTorch path).  Unlike the JAX engine, admission writes the
KV cache in place (the engine owns it); the values are the same.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import KEY_DOMAIN_HI, KEY_MAX, OpBatch, Uruv, UruvConfig
from repro_torch.config import ArchConfig
from repro_torch.core.store import resolve_device
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.serve.coalescer import AdmissionPolicy, Coalescer


def prefix_hash(tokens) -> int:
    """FNV-style rolling hash of a token prefix, clamped into the store's
    key domain ``[1, KEY_DOMAIN_HI - 1]`` (never a sentinel key)."""
    h = 2166136261
    for t in tokens:
        h = (h * 16777619 + int(t) + 1) & KEY_MAX
    return int(h) % (KEY_DOMAIN_HI - 1) + 1


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    eos: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_reused: int = 0


class Engine:
    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 max_len: int = 128, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.api = get_model(cfg)
        assert self.api.decode_step is not None
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = self.api.init_cache(cfg, n_slots, max_len,
                                         device=self.device)
        self.lengths = np.zeros(n_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: Deque[Request] = collections.deque()
        # the table starts small and self-sizes: admission churn retires
        # prefix entries continuously, and the client's lifecycle policy
        # grows pools on pressure and interleaves maintain passes
        self.table = Uruv(UruvConfig(
            leaf_cap=16, max_leaves=256, max_versions=1 << 12),
            device=self.device)
        # table traffic goes through the pipelined admission layer: plans
        # coalesce into pow2 buckets; the engine blocks on a plan's future
        # only when it needs the donor answer
        self.coalescer = Coalescer(self.table, AdmissionPolicy())
        self._slot_keys: Dict[int, List[int]] = {i: [] for i in
                                                 range(n_slots)}
        self._is_tf = cfg.family in ("dense", "moe", "vlm") \
            and cfg.vlm is None

    def _decode(self, tokens: np.ndarray):
        return self.api.decode_step(self.cfg, self.params, tokens,
                                    self.cache, self.lengths)

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @staticmethod
    def _select_donor(plens, vals) -> Tuple[int, int]:
        """Longest prefix whose cached entry covers it -> (donor_slot,
        plen); a hit is usable iff its published length covers the probed
        prefix (``ln >= plen`` — hash-collision guard)."""
        best = (-1, 0)
        for plen, v in zip(plens, vals):
            if v >= 0:
                slot, ln = int(v) >> 16, int(v) & 0xFFFF
                if ln >= plen:
                    best = (slot, plen)
        return best

    def _lookup_prefix(self, prompt: List[int]) -> Tuple[int, int]:
        """Longest cached prefix -> (donor_slot, plen); (-1, 0) if none."""
        keys, plens = [], []
        for plen in range(1, len(prompt) + 1):
            keys.append(prefix_hash(prompt[:plen]))
            plens.append(plen)
        vals = self.table.lookup(np.array(keys, np.int32), pad_to_pow2=True)
        return self._select_donor(plens, vals)

    def _admission_pass(self, slot: int, prompt: List[int]
                        ) -> Tuple[int, int]:
        """Retire + prefix-lookup + publish as ONE mixed plan: DELETE the
        retiring slot's stale prefix keys, SEARCH every prompt prefix,
        then INSERT the new prefix entries.  Returns (donor, plen)."""
        old_keys = self._slot_keys[slot]
        n = len(prompt)
        pkeys = [prefix_hash(prompt[:p]) for p in range(1, n + 1)]
        plan = OpBatch.concat(
            OpBatch.deletes(np.array(old_keys, np.int32)),
            OpBatch.searches(np.array(pkeys, np.int32)),
            OpBatch.inserts(
                np.array(pkeys, np.int32),
                np.array([(slot << 16) | p for p in range(1, n + 1)],
                         np.int32)),
        )
        res = self.coalescer.submit(plan).result()
        self._slot_keys[slot] = list(pkeys)
        search_vals = res.values[len(old_keys):len(old_keys) + n]
        return self._select_donor(range(1, n + 1), search_vals)

    def _copy_kv(self, dst: int, src: int, upto: int) -> None:
        for name in ("k", "v"):
            c = self.cache[name]                     # [L, B, KVH, S, hd]
            c[:, dst, :, :upto] = c[:, src, :, :upto]

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            donor, plen = self._admission_pass(slot, req.prompt)
            if donor >= 0 and donor != slot and plen > 1 and self._is_tf:
                self._copy_kv(slot, donor, plen)
                start, base_len = plen, plen
                req.prefix_reused = plen
            else:
                start, base_len = 0, 0
            if self._is_tf and start == 0 and len(req.prompt) > 1:
                toks = np.array(req.prompt, np.int32)[None, :]
                _, cache1 = transformer.prefill(self.cfg, self.params, toks,
                                                self.max_len)
                for name in ("k", "v"):
                    self.cache[name][:, slot] = cache1[name][:, 0]
                self.lengths[slot] = len(req.prompt)
            else:
                # step-by-step prompt feed (partial reuse)
                self.lengths[slot] = base_len
                for t in req.prompt[start:]:
                    self._step_single(slot, t)
            self.slot_req[slot] = req

    def _step_single(self, slot: int, token: int) -> None:
        toks = np.zeros(self.n_slots, np.int32)
        toks[slot] = token
        logits, self.cache = self._decode(toks)
        self.lengths[slot] += 1
        self._last_logits = logits

    # ----------------------------------------------------------------- steps
    def step(self) -> None:
        """One engine tick: admit, batched decode, completions."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        toks = np.zeros(self.n_slots, np.int32)
        for i in active:
            r = self.slot_req[i]
            toks[i] = (r.out[-1] if r.out else r.prompt[-1])
        logits, self.cache = self._decode(toks)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for i in active:
            r = self.slot_req[i]
            self.lengths[i] += 1
            tok = int(nxt[i])
            r.out.append(tok)
            if (tok == r.eos or len(r.out) >= r.max_new
                    or self.lengths[i] >= self.max_len - 1):
                r.done = True
                self.slot_req[i] = None

    def run(self, requests: List[Request], max_ticks: int = 1000
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            self.step()
            if all(r.done for r in requests):
                break
        return requests

    @property
    def table_stats(self) -> Dict[str, int]:
        """Store-lifecycle observability: device passes, grows, maintain
        passes, leaves reclaimed."""
        return dict(self.table.stats)

    # scheduler view: a consistent snapshot of the table, one batched
    # range pass per pagination round, at a registered snapshot
    def snapshot_view(self) -> List[Tuple[int, int]]:
        return self.snapshot_views([(0, KEY_DOMAIN_HI)])[0]

    def snapshot_views(self, bounds: List[Tuple[int, int]]
                       ) -> List[List[Tuple[int, int]]]:
        """N key-range views at ONE registered snapshot (released on exit,
        even on error)."""
        with self.table.snapshot() as snap:
            return self.table.range_all(
                [lo for lo, _ in bounds], [hi for _, hi in bounds],
                snap, scan_leaves=32, max_rounds=8)
