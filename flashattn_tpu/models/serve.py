"""Continuous-batching inference server (BASELINE.json north_star:
"cu_seqlens continuous batching" — the serving-side realization).

Slot-based scheduler over the decode path: a fixed-shape batch of
`max_slots` cache rows; requests admit into free slots (prefill runs B=1 on
a bucket-padded prompt and the filled cache installs via kvcache.write_slot),
every decode step advances ALL active slots in one jitted step
(inactive slots compute but do not advance — update_cache(active=...)), and
finished slots free immediately for the next queued request. All device
shapes are static, so the serving loop reuses a bounded set of compiled
executables (one prefill per prompt bucket + one decode step).

The reference has no serving layer (SURVEY.md §0: "no training loop, no
model, no serving"); the varlen design it defers (Phase_6.md:118-178) covers
the packed-training side, this covers decode.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import jax
import jax.numpy as jnp

from flashattn_tpu.models import generate
from flashattn_tpu.models.config import ModelConfig
from flashattn_tpu.models.sampling import SamplingParams, sample
from flashattn_tpu.ops.common import round_up
from flashattn_tpu.ops.kvcache import init_cache, write_slot
from flashattn_tpu.ops.paged import (
    PageAllocator,
    init_paged_cache,
    pages_needed,
    pages_to_dense,
    set_block_table,
    write_pages,
    write_slot_paged,
)

Params = dict[str, Any]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_token: int | None = None
    # Shared-prefix handle from InferenceServer.register_prefix (paged
    # backend only). The prompt must start with the registered tokens; the
    # prefix's pages are shared read-only across every request using it.
    prefix_id: int | None = None
    # None = greedy. Sampling is keyed on (server seed, uid, position), so
    # a request's output is reproducible regardless of batch composition.
    sampling: SamplingParams | None = None


@dataclasses.dataclass
class _Slot:
    uid: int = -1
    remaining: int = 0
    position: int = 0  # position index of the token in self.tokens
    eos: int | None = None
    sampling: SamplingParams | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    lps: list[float] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.uid < 0


class InferenceServer:
    """Greedy continuous-batching engine. Synchronous API: submit() any
    time, step() advances one token for every active slot, run() drains."""

    def __init__(
        self,
        params: Params,
        cfg: ModelConfig,
        max_slots: int = 8,
        max_len: int = 2048,
        quant: str | None = None,
        prompt_bucket: int = 128,
        paged: bool = False,
        page_size: int = 1024,
        num_pages: int | None = None,
        admit_chunk: int | None = None,
        seed: int = 0,
        return_logprobs: bool = False,
    ):
        """paged=True backs the KV cache with a shared page pool (block
        tables): a slot holds only `ceil((prompt+max_new)/page_size)` pages
        instead of a full max_len row, so `num_pages` sizes memory to the
        expected LIVE context sum, admitting more concurrent sequences than
        dense slots would. Requests whose pages cannot be allocated stay
        queued (admission backpressure) instead of failing.

        admit_chunk=N turns admission into Sarathi-style chunked prefill:
        each step() processes at most ONE N-token prompt chunk (through the
        batch caches, other slots held still) before the decode step, so a
        long prompt bounds the decode stall to one chunk instead of its
        whole prefill. Works on both backends; the prompt streams straight
        into the slot's cache row / pages — no B=1 staging buffer."""
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.quant = quant
        self.prompt_bucket = prompt_bucket
        self.paged = paged
        self.page_size = page_size
        self.admit_chunk = admit_chunk
        self._rng = jax.random.PRNGKey(seed)
        # Phase timing (stats()): wall seconds per step phase, so scheduler
        # overhead (admission + host sampling/readback) is measurable
        # against the decode dispatch instead of hiding in tok/s.
        self._timing = {"steps": 0, "decode_steps": 0, "decode_s": 0.0,
                        "admit_s": 0.0, "host_s": 0.0, "decoded_tokens": 0}
        self._device_step_s: float | None = None
        self.return_logprobs = return_logprobs
        self.finished_logprobs: dict[int, list[float]] = {}
        # slot -> [req, next_prompt_pos] while its prompt streams in chunks
        self._admitting: dict[int, list] = {}
        if paged:
            assert max_len % page_size == 0, (max_len, page_size)
            self.max_pages_per_seq = max_len // page_size
            if num_pages is None:
                num_pages = max_slots * self.max_pages_per_seq
            self.allocator = PageAllocator(num_pages)
            self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
            self._slot_shared: list[list[int]] = [[] for _ in range(max_slots)]
            # prefix_id -> (tokens, pages); pages hold one registry ref.
            self._prefixes: dict[int, tuple[list[int], list[int]]] = {}
            self._next_prefix_id = 0
            self.caches = [
                init_paged_cache(
                    max_slots, cfg.num_kv_heads, num_pages, page_size,
                    cfg.head_dim, self.max_pages_per_seq,
                    dtype=cfg.dtype, quant=quant)
                for _ in range(cfg.num_layers)
            ]
        else:
            self.caches = [
                init_cache(max_slots, cfg.num_kv_heads, max_len,
                           cfg.head_dim, dtype=cfg.dtype, quant=quant)
                for _ in range(cfg.num_layers)
            ]
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: deque[Request] = deque()
        self.tokens = jnp.zeros((max_slots,), jnp.int32)
        self.finished: dict[int, list[int]] = {}

    def submit(self, req: Request) -> None:
        assert len(req.prompt) + req.max_new_tokens <= self.max_len, (
            "request exceeds max_len")
        if self.admit_chunk:
            # The final streamed chunk writes a full admit_chunk-wide piece
            # at the last chunk boundary; it must fit the cache row or the
            # clamped write would shift the prompt's own K/V.
            c = self.admit_chunk
            padded = -(-max(len(req.prompt), 1) // c) * c
            assert padded <= self.max_len, (
                f"prompt ({len(req.prompt)}) rounded to admit_chunk ({c}) "
                f"exceeds max_len ({self.max_len})")
        if req.prefix_id is not None:
            assert self.paged, "prefix sharing needs the paged backend"
            assert req.prefix_id in self._prefixes, (
                f"unknown prefix_id {req.prefix_id}")
            ptoks, _ = self._prefixes[req.prefix_id]
            assert req.prompt[:len(ptoks)] == ptoks, (
                "prompt does not start with the registered prefix")
        if self.paged:
            need = pages_needed(
                len(req.prompt) + req.max_new_tokens, self.page_size)
            if req.prefix_id is not None:
                need -= len(self._shared_split(req)[1])
            if need > self.allocator.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.allocator.num_pages} — it could never be "
                    "admitted (backpressure would spin forever)")
        self.queue.append(req)

    def register_prefix(self, tokens: list[int]) -> int:
        """Prefill a shared prompt prefix ONCE into pool pages; requests
        submitted with the returned prefix_id reuse those pages read-only
        (they are never written again: appends land at length >= prefix).
        Only full pages are shared — the tail shorter than page_size is
        re-processed per request as part of its suffix."""
        assert self.paged, "prefix caching needs the paged backend"
        shared = (len(tokens) // self.page_size) * self.page_size
        assert shared > 0, (
            f"prefix shorter than one page ({self.page_size}) shares nothing")
        tokens = list(tokens[:shared])
        prompt = jnp.asarray([tokens], jnp.int32)
        single = [
            init_cache(1, self.cfg.num_kv_heads, self.max_len,
                       self.cfg.head_dim, dtype=self.cfg.dtype,
                       quant=self.quant)
            for _ in range(self.cfg.num_layers)
        ]
        _, single = generate.prefill(self.params, prompt, single, self.cfg)
        pages = self.allocator.alloc(shared // self.page_size)
        arr = jnp.asarray(pages, jnp.int32)
        for li in range(self.cfg.num_layers):
            self.caches[li] = write_pages(self.caches[li], single[li], arr)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = (tokens, pages)
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop the registry's reference; the pages free once the last
        in-flight request using them finishes."""
        _, pages = self._prefixes.pop(prefix_id)
        self.allocator.release(pages)

    def _make_table(self, pages: list[int]) -> "jnp.ndarray":
        """Pad an owned-page list to a device block table. Unowned tail
        entries carry an out-of-range sentinel (== num_pages): install
        scatters drop those blocks, and decode never clamps into them
        (live blocks <= owned by construction)."""
        sentinel = self.allocator.num_pages
        return jnp.asarray(
            pages + [sentinel] * (self.max_pages_per_seq - len(pages)),
            jnp.int32)

    def _shared_split(self, req: Request) -> tuple[int, list[int]]:
        """(shared_len, shared_pages) for a request — full prefix pages
        only, and always leaving a non-empty suffix (the admission needs
        the last prompt token's logits, which shared pages do not carry)."""
        if req.prefix_id is None:
            return 0, []
        ptoks, ppages = self._prefixes[req.prefix_id]
        plen = len(req.prompt)
        shared = min(len(ptoks),
                     ((plen - 1) // self.page_size) * self.page_size)
        return shared, ppages[:shared // self.page_size]

    def _admit(self) -> None:
        for s, slot in enumerate(self.slots):
            if not self.queue or not slot.free:
                continue
            if self.paged:
                nxt = self.queue[0]
                shared, spages = self._shared_split(nxt)
                need = pages_needed(
                    len(nxt.prompt) + nxt.max_new_tokens,
                    self.page_size) - len(spages)
                if need > self.allocator.free_pages:
                    # Backpressure: keep queued until pages free up. But if
                    # NOTHING is in flight, the free pool is already maximal
                    # (only registered prefixes hold pages) — waiting can
                    # never help, so fail loudly instead of livelocking.
                    if (all(sl.free for sl in self.slots)
                            and not self._admitting):
                        raise RuntimeError(
                            f"request {nxt.uid} needs {need} pages but only "
                            f"{self.allocator.free_pages} can ever be free "
                            "(registered prefixes hold the rest) — "
                            "unregister a prefix or grow num_pages")
                    return
            req = self.queue.popleft()
            if self.admit_chunk:
                self._begin_chunked_admission(s, req)
                continue
            if self.paged and req.prefix_id is not None and spages:
                self._admit_with_prefix(s, req, shared, spages)
                continue
            plen = len(req.prompt)
            padded = min(round_up(max(plen, 1), self.prompt_bucket),
                         self.max_len)
            prompt = jnp.zeros((1, padded), jnp.int32).at[0, :plen].set(
                jnp.asarray(req.prompt, jnp.int32))
            single = [
                init_cache(1, self.cfg.num_kv_heads, self.max_len,
                           self.cfg.head_dim, dtype=self.cfg.dtype,
                           quant=self.quant)
                for _ in range(self.cfg.num_layers)
            ]
            logits, single = generate.prefill(
                self.params, prompt, single, self.cfg, return_all=True)
            # Padding tokens sit AFTER the prompt, so causal attention keeps
            # real rows exact; resetting length=plen makes the padded k/v
            # dead (next appends land at plen and overwrite them).
            if self.paged:
                owned = self.allocator.alloc(
                    pages_needed(plen + req.max_new_tokens, self.page_size))
                self._slot_pages[s] = owned
                table = self._make_table(owned)
            for li in range(self.cfg.num_layers):
                single[li] = dataclasses.replace(
                    single[li], length=jnp.asarray([plen], jnp.int32))
                if self.paged:
                    self.caches[li] = write_slot_paged(
                        self.caches[li], single[li], s, table)
                else:
                    self.caches[li] = write_slot(self.caches[li], single[li], s)
            first = self._pick(logits[0, plen - 1], req.uid, req.sampling,
                               plen - 1)
            self._start_slot(s, req, first, logits[0, plen - 1])

    def _pick(self, logits_row: jnp.ndarray, uid: int,
              sampling: SamplingParams | None, position: int) -> int:
        """Next token from one slot's [V] logits: greedy, or sampled with a
        key derived from (server seed, uid, position) — reproducible
        independent of batch composition and slot placement."""
        if sampling is None or sampling.temperature == 0.0:
            return int(jnp.argmax(logits_row))
        key = jax.random.fold_in(
            jax.random.fold_in(self._rng, uid), position)
        return int(sample(logits_row[None], key, sampling)[0])

    def _logprob(self, logits_row: jnp.ndarray, tok: int) -> float:
        return float(logits_row[tok]
                     - jax.scipy.special.logsumexp(logits_row))

    def _start_slot(self, s: int, req: Request, first: int,
                    logits_row: jnp.ndarray | None = None) -> None:
        plen = len(req.prompt)
        lps = ([self._logprob(logits_row, first)]
               if self.return_logprobs and logits_row is not None else [])
        self.slots[s] = slot = _Slot(
            uid=req.uid, remaining=req.max_new_tokens - 1,
            position=plen, eos=req.eos_token, sampling=req.sampling,
            out=[first], lps=lps)
        self.tokens = self.tokens.at[s].set(first)
        if slot.remaining <= 0 or (slot.eos is not None
                                   and first == slot.eos):
            self._finish(s)

    def _admit_with_prefix(self, s: int, req: Request, shared: int,
                           spages: list[int]) -> None:
        """Admission reusing a registered prefix's pages: only the suffix is
        prefilled, seeded with the shared K/V gathered back to a dense B=1
        cache (raw quantized payload — no requantization), then installed
        into freshly-owned pages from the suffix's first block onward."""
        plen = len(req.prompt)
        suffix = req.prompt[shared:]
        nshared = len(spages)
        own = self.allocator.alloc(
            pages_needed(plen + req.max_new_tokens, self.page_size) - nshared)
        self.allocator.retain(spages)
        self._slot_pages[s] = own
        self._slot_shared[s] = spages
        table = self._make_table(spages + own)

        padded = min(round_up(len(suffix), self.prompt_bucket),
                     self.max_len - shared)
        piece = jnp.zeros((1, padded), jnp.int32).at[0, :len(suffix)].set(
            jnp.asarray(suffix, jnp.int32))
        positions = jnp.arange(shared, shared + padded)
        sarr = jnp.asarray(spages, jnp.int32)
        single = [
            pages_to_dense(self.caches[li], sarr, max_len=self.max_len,
                           length=shared)
            for li in range(self.cfg.num_layers)
        ]
        # chunk_step attends cache-so-far (the prefix) + the chunk causally;
        # padding tokens append dead K/V (length resets to plen below).
        logits, single = generate.chunk_step(
            self.params, piece, positions, single, self.cfg)
        oarr = jnp.asarray(own, jnp.int32)
        for li in range(self.cfg.num_layers):
            self.caches[li] = write_pages(
                self.caches[li], single[li], oarr, first_block=nshared)
            self.caches[li] = set_block_table(self.caches[li], s, table, plen)
        first = self._pick(logits[0, len(suffix) - 1], req.uid, req.sampling,
                           plen - 1)
        self._start_slot(s, req, first, logits[0, len(suffix) - 1])

    def _set_slot_length(self, s: int, n: int) -> None:
        for li in range(self.cfg.num_layers):
            c = self.caches[li]
            self.caches[li] = dataclasses.replace(
                c, length=c.length.at[s].set(n))

    def _begin_chunked_admission(self, s: int, req: Request) -> None:
        """Claim the slot and (paged) its pages; the prompt itself streams
        through _prefill_chunk, one admit_chunk per step."""
        shared, spages = (self._shared_split(req)
                          if self.paged else (0, []))
        if self.paged:
            own = self.allocator.alloc(
                pages_needed(len(req.prompt) + req.max_new_tokens,
                             self.page_size) - len(spages))
            if spages:
                self.allocator.retain(spages)
            self._slot_pages[s] = own
            self._slot_shared[s] = spages
            table = self._make_table(spages + own)
            for li in range(self.cfg.num_layers):
                self.caches[li] = set_block_table(
                    self.caches[li], s, table, shared)
        else:
            self._set_slot_length(s, 0)
        # Placeholder slot: occupied (uid set) but not decodable until the
        # prompt has fully streamed in.
        self.slots[s] = _Slot(uid=req.uid, remaining=req.max_new_tokens,
                              position=0, eos=req.eos_token, out=[])
        self._admitting[s] = [req, shared]

    def _prefill_chunk(self, s: int) -> None:
        """Stream one admit_chunk of slot s's prompt through the batch
        caches (other slots inactive); on the final chunk the slot becomes
        a decodable _Slot carrying the prompt's first sampled token."""
        req, pos = self._admitting[s]
        plen = len(req.prompt)
        c = self.admit_chunk
        take = min(c, plen - pos)
        b = len(self.slots)
        piece = jnp.zeros((b, c), jnp.int32).at[s, :take].set(
            jnp.asarray(req.prompt[pos:pos + take], jnp.int32))
        positions = jnp.zeros((b, c), jnp.int32).at[s].set(
            jnp.arange(pos, pos + c))
        active = jnp.zeros((b,), bool).at[s].set(True)
        logits, self.caches = generate.chunk_step(
            self.params, piece, positions, self.caches, self.cfg,
            active=active)
        pos += take
        if pos < plen:
            self._admitting[s][1] = pos
            return
        # Final chunk: the padded tail appended dead K/V — pin the length.
        if take < c:
            self._set_slot_length(s, plen)
        del self._admitting[s]
        first = self._pick(logits[s, take - 1], req.uid, req.sampling,
                           plen - 1)
        self._start_slot(s, req, first, logits[s, take - 1])

    def _finish(self, s: int) -> None:
        slot = self.slots[s]
        self.finished[slot.uid] = slot.out
        if self.return_logprobs:
            self.finished_logprobs[slot.uid] = slot.lps
        self.slots[s] = _Slot()
        if self.paged and self._slot_pages[s]:
            self.allocator.release(self._slot_pages[s])
            self._slot_pages[s] = []
        if self.paged and self._slot_shared[s]:
            self.allocator.release(self._slot_shared[s])  # drop prefix ref
            self._slot_shared[s] = []

    def step(self) -> None:
        """Admit queued requests, stream at most one prompt chunk, then
        advance every decodable slot one token."""
        t0 = time.perf_counter()
        self._admit()
        if self._admitting:
            # Round-robin across streaming slots: process the front, then
            # rotate it to the back so a short prompt admitted second is
            # not starved behind a long one's chunks.
            s = next(iter(self._admitting))
            self._prefill_chunk(s)
            if s in self._admitting:
                self._admitting[s] = self._admitting.pop(s)
        active = [not s.free and i not in self._admitting
                  for i, s in enumerate(self.slots)]
        t1 = time.perf_counter()
        self._timing["admit_s"] += t1 - t0
        self._timing["steps"] += 1
        if not any(active):
            return  # admit-only step (counted; no decode phase)
        positions = jnp.asarray([s.position for s in self.slots], jnp.int32)
        logits, self.caches = generate.decode_step(
            self.params, self.tokens, positions, self.caches, self.cfg,
            active=jnp.asarray(active))
        nxt = jax.device_get(jnp.argmax(logits, axis=-1).astype(jnp.int32))
        t2 = time.perf_counter()  # first sync: decode phase complete
        self._timing["decode_s"] += t2 - t1
        live = [s for s, slot in enumerate(self.slots)
                if not slot.free and s not in self._admitting]
        # Mid-admission placeholders hold no decodable state: their logits
        # rows are garbage and must not advance/finish them (skipped above).
        # Greedy slots read from the already-batched argmax; sampled slots
        # are grouped by SamplingParams (hashable frozen dataclass) and each
        # group draws in ONE vmapped sample + ONE device readback — per-slot
        # _pick calls would cost a host-device round-trip per slot per step.
        # Per-slot keys are derived exactly as _pick does, so draws stay
        # reproducible regardless of batch composition.
        toks: dict[int, int] = {}
        by_params: dict[SamplingParams, list[int]] = {}
        for s in live:
            sp = self.slots[s].sampling
            if sp is None or sp.temperature == 0.0:
                toks[s] = int(nxt[s])
            else:
                by_params.setdefault(sp, []).append(s)
        for sp, group in by_params.items():
            keys = jnp.stack([
                jax.random.fold_in(
                    jax.random.fold_in(self._rng, self.slots[s].uid),
                    self.slots[s].position)
                for s in group])
            draws = jax.device_get(jax.vmap(
                lambda l, k, sp=sp: sample(l[None], k, sp)[0]
            )(logits[jnp.asarray(group)], keys))
            for i, s in enumerate(group):
                toks[s] = int(draws[i])
        if self.return_logprobs and live:
            # One batched gather + logsumexp + readback for every live slot
            # (per-slot _logprob syncs would cost O(B) host round-trips).
            rows = jnp.asarray(live)
            cols = jnp.asarray([toks[s] for s in live])
            lps = jax.device_get(
                logits[rows, cols]
                - jax.scipy.special.logsumexp(logits[rows], axis=-1))
            for i, s in enumerate(live):
                self.slots[s].lps.append(float(lps[i]))
        for s in live:
            slot = self.slots[s]
            tok = toks[s]
            slot.position += 1
            slot.remaining -= 1
            slot.out.append(tok)
            self.tokens = self.tokens.at[s].set(tok)
            if slot.remaining <= 0 or (slot.eos is not None
                                       and tok == slot.eos):
                self._finish(s)
        self._timing["host_s"] += time.perf_counter() - t2
        self._timing["decode_steps"] += 1
        self._timing["decoded_tokens"] += len(live)

    def device_step_fn(self):
        """The pure decode-step callable timed by calibrate_device_step,
        plus its argument tuple. params/caches must ride as jit ARGUMENTS:
        closing over them bakes ~2.4 GB of weights into the traced HLO as
        constants, which blows up the compile payload (measured round 3:
        the remote-compile transport dies with a broken pipe) and
        double-allocates the weights. tests/test_serve.py asserts the
        closure's trace-time constants stay tiny."""
        b = len(self.slots)
        positions = jnp.asarray(
            [max(s.position, 1) if not s.free else 1 for s in self.slots],
            jnp.int32)
        act = jnp.ones((b,), bool)

        def fn(tokens, params, caches):
            return generate.decode_step(params, tokens, positions,
                                        caches, self.cfg, active=act)[0]

        return fn, (self.tokens, self.params, self.caches)

    def calibrate_device_step(self, iters: int = 100) -> float:
        """Measure the PURE decode-step device time with the on-device
        chain SLOPE (utils.timing.measure_looped_slope — a single chain
        reading still smears the fixed dispatch cost over the iterations;
        the two-length slope cancels it). Stored and reported
        by stats() as device_step_ms, giving the device-side tokens/s
        bound the scheduler overhead is measured against. `iters` < 50
        (CPU-interpret tests) keeps the cheap single-chain estimate."""
        from flashattn_tpu.utils.timing import (
            measure_looped,
            measure_looped_slope,
        )

        fn, args = self.device_step_fn()
        if iters < 50:
            self._device_step_s = measure_looped(fn, *args, iters=iters)
        else:
            self._device_step_s = measure_looped_slope(fn, *args)
        return self._device_step_s

    def calibrate_admit(self, prompt_len: int, prefix_len: int,
                        iters: int = 50) -> dict[str, float]:
        """Device-time of admission with vs without a shared prefix.

        A wall-clock A/B of admission includes the host's dispatch cost on
        both arms, which hides the prefill FLOPs saved on the device. This
        measures the ADMISSION COMPUTE itself with the on-device scan loop (event-timing discipline, reference
        ``Performance_Comparison.py:111-128``):

          replicated: full-prompt chunk prefill + page install
          shared:     prefix pages gathered to a dense seed + suffix-only
                      chunk prefill + suffix page install
                      (exactly ``_admit_with_prefix``'s compute)

        Returns ms per admission for both paths and the device speedup.
        Pure: touches no live pool/table state (all cache ops are
        functional; results are discarded)."""
        from flashattn_tpu.ops.paged import pages_to_dense, write_pages
        from flashattn_tpu.utils.timing import (
            measure_looped,
            measure_looped_slope,
        )

        assert self.paged, "prefix calibration requires the paged backend"
        assert 0 < prefix_len < prompt_len <= self.max_len
        assert prefix_len % self.page_size == 0, (
            "register_prefix shares whole pages")
        nshared = prefix_len // self.page_size
        n_all = pages_needed(prompt_len, self.page_size)
        pages_all = jnp.arange(n_all, dtype=jnp.int32)

        padded_full = min(round_up(prompt_len, self.prompt_bucket),
                          self.max_len)
        pos_full = jnp.arange(padded_full)
        empty = [
            init_cache(1, self.cfg.num_kv_heads, self.max_len,
                       self.cfg.head_dim, dtype=self.cfg.dtype,
                       quant=self.quant)
            for _ in range(self.cfg.num_layers)
        ]

        # Long prompts prefill in admission-sized pieces, as the real
        # admission path streams them (one decode-chunk call over the whole
        # prompt materializes a [rows, max_len] score tile per layer).
        cal_chunk = min(512, padded_full)

        def replicated(piece, params, caches, empty):
            single = empty
            logits = None
            for c0 in range(0, padded_full, cal_chunk):
                logits, single = generate.chunk_step(
                    params, piece[:, c0:c0 + cal_chunk],
                    pos_full[c0:c0 + cal_chunk], single, self.cfg)
            # Depend on EVERY layer's install + the logits, or XLA dead-
            # code-eliminates all but the returned one out of the timing.
            deps = [logits.reshape(-1)[0]]
            for li in range(self.cfg.num_layers):
                c = write_pages(caches[li], single[li], pages_all)
                deps.append(c.k_pages.reshape(-1)[0].astype(jnp.float32))
            return jnp.stack(deps)

        suffix_len = prompt_len - prefix_len
        padded_suf = min(round_up(suffix_len, self.prompt_bucket),
                         self.max_len - prefix_len)
        pos_suf = jnp.arange(prefix_len, prefix_len + padded_suf)
        sarr = pages_all[:nshared]
        oarr = pages_all[nshared:]

        def shared(piece, params, caches):
            single = [
                pages_to_dense(caches[li], sarr, max_len=self.max_len,
                               length=prefix_len)
                for li in range(self.cfg.num_layers)
            ]
            logits, single = generate.chunk_step(params, piece,
                                                 pos_suf, single, self.cfg)
            deps = [logits.reshape(-1)[0]]
            for li in range(self.cfg.num_layers):
                c = write_pages(caches[li], single[li], oarr,
                                first_block=nshared)
                deps.append(c.k_pages.reshape(-1)[0].astype(jnp.float32))
            return jnp.stack(deps)

        # params/caches ride as chain ARGUMENTS (weights baked into the
        # trace as constants bloat the compile).
        rep_args = (jnp.zeros((1, padded_full), jnp.int32), self.params,
                    self.caches, empty)
        sh_args = (jnp.zeros((1, padded_suf), jnp.int32), self.params,
                   self.caches)
        if iters < 50:  # CPU-interpret tests: cheap single chain
            t_rep = measure_looped(replicated, *rep_args, iters=iters)
            t_sh = measure_looped(shared, *sh_args, iters=iters)
        else:
            t_rep = measure_looped_slope(replicated, *rep_args)
            t_sh = measure_looped_slope(shared, *sh_args)
        return {
            "prefill_ms_replicated": round(t_rep * 1e3, 3),
            "prefill_ms_shared": round(t_sh * 1e3, 3),
            "device_speedup": round(t_rep / t_sh, 2),
        }

    def run(self) -> dict[int, list[int]]:
        """Drain queue + slots; returns {uid: generated tokens}."""
        while self.queue or any(not s.free for s in self.slots):
            self.step()
        out, self.finished = self.finished, {}
        return out

    def warmup(self) -> None:
        """Compile the serving executables before traffic: every prompt
        bucket's prefill (or the admit_chunk step) and the fused decode
        step. First-compile latency (seconds per shape) then never hits
        a live request."""
        b = len(self.slots)
        if self.admit_chunk:
            c = self.admit_chunk
            piece = jnp.zeros((b, c), jnp.int32)
            positions = jnp.zeros((b, c), jnp.int32)
            generate.chunk_step(self.params, piece, positions, self.caches,
                                self.cfg, active=jnp.zeros((b,), bool))
        else:
            # Admission pads to min(round_up(plen, bucket), max_len): when
            # max_len is not a bucket multiple the clamped max_len shape is
            # a real prefill shape too — precompile it or the first long
            # prompt eats the compile stall warmup exists to hide.
            buckets = sorted(set(
                range(self.prompt_bucket, self.max_len + 1,
                      self.prompt_bucket)) | {self.max_len})
            single = [
                init_cache(1, self.cfg.num_kv_heads, self.max_len,
                           self.cfg.head_dim, dtype=self.cfg.dtype,
                           quant=self.quant)
                for _ in range(self.cfg.num_layers)
            ]
            for padded in buckets:
                generate.prefill(self.params,
                                 jnp.zeros((1, padded), jnp.int32),
                                 single, self.cfg, return_all=True)
        generate.decode_step(
            self.params, self.tokens,
            jnp.zeros((b,), jnp.int32), self.caches, self.cfg,
            active=jnp.zeros((b,), bool))

    def stats(self) -> dict[str, Any]:
        """Observability snapshot (SURVEY §5 metrics): occupancy, queue
        depth, and — paged — page-pool utilization incl. shared prefixes."""
        active = sum(not s.free for s in self.slots)
        st = {
            "active_slots": active,
            "max_slots": len(self.slots),
            "queued": len(self.queue),
            "live_tokens": sum(s.position for s in self.slots if not s.free),
        }
        if self.paged:
            total = self.allocator.num_pages
            st.update(
                pages_total=total,
                pages_free=self.allocator.free_pages,
                pages_used=total - self.allocator.free_pages,
                prefix_pages=sum(len(p) for _, p in self._prefixes.values()),
                page_utilization=round(
                    1 - self.allocator.free_pages / total, 3),
            )
        t = self._timing
        if t["steps"]:
            wall = t["decode_s"] + t["admit_s"] + t["host_s"]
            dsteps = max(t["decode_steps"], 1)
            st.update(
                steps=t["steps"],
                decode_steps=t["decode_steps"],
                decode_ms_avg=round(1e3 * t["decode_s"] / dsteps, 3),
                admit_ms_avg=round(1e3 * t["admit_s"] / t["steps"], 3),
                host_ms_avg=round(1e3 * t["host_s"] / dsteps, 3),
                # Fraction of step wall NOT spent in the decode dispatch —
                # the scheduler/host overhead the device-side bound exposes.
                sched_overhead_frac=round(
                    (t["admit_s"] + t["host_s"]) / max(wall, 1e-9), 3),
                wall_tokens_per_s=round(
                    t["decoded_tokens"] / max(wall, 1e-9), 1),
            )
        if self._device_step_s:
            st["device_step_ms"] = round(1e3 * self._device_step_s, 4)
            st["device_tokens_per_s_bound"] = round(
                len(self.slots) / self._device_step_s, 1)
        return st
