"""Continuous-batching autoregressive serving (counterpart of
`bigdl_tpu/serving/generation.py`).

- **Prefill.** A queued prompt is padded to a power-of-two sequence bucket
  and grouped with same-bucket neighbours into a power-of-two batch
  bucket. One causal full-sequence forward (its attention is the flash
  forward kernel on the card) commits each prompt's per-layer K/V into
  that request's slot of a preallocated `[slots, heads, max_len,
  head_dim]` cache and yields the first generated token.
- **Decode.** One fixed-shape step over ALL slots
  (`TransformerLM.apply_step`): each active slot's last token goes in at
  its own position, its K/V is written in place, and the next greedy
  token comes out. Inactive slots ride along at position 0.

Requests join a free slot as soon as their prefill lands and leave at
EOS / max tokens between decode steps. Every slot's math is row
independent, so a request's tokens do not depend on its co-tenants:
greedy decode here gives the tokens of one-request-at-a-time
full-recompute decode (`greedy_decode_reference`), up to float rounding
where two candidates nearly tie.

The dispatcher thread runs the model under `torch.inference_mode()`,
which it enters itself: grad mode is per thread. The KV cache is written
in place; a failed prefill or decode leaves it unknown, so the engine
then fails the active streams and allocates a fresh cache.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.serving.engine import (EngineClosedError, ServingEngine,
                                            ServingError,
                                            ServingTimeoutError)

logger = logging.getLogger("bigdl_tpu_torch.serving")


def default_seq_buckets(max_len: int, floor: int = 8) -> List[int]:
    """Power-of-two prompt pad targets up to (and always including)
    `max_len`: 64 -> [8, 16, 32, 64], 48 -> [8, 16, 32, 48]."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    out, b = [], min(floor, max_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class TokenStream:
    """Streaming token future for ONE generation request.

    The engine appends tokens as it produces them; the caller consumes
    them concurrently: iterate (blocks per token, raising the request's
    failure where the stream died), `result(timeout)` for the full list,
    `get(i, timeout)` for token `i` (None once the stream finished OK with
    fewer tokens), `cancel()` to stop at the next step boundary.

    Thread-safe. `status` is None while streaming, then one of
    "ok"/"timeout"/"error"/"cancelled". Token ids are 1-based; an EOS
    token is emitted before the stream finishes.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._status: Optional[str] = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False

    # ---- producer side (engine internals)
    def _put(self, tok: int):
        with self._cond:
            self._tokens.append(int(tok))
            self._cond.notify_all()

    def _finish(self, status: str = "ok",
                exc: Optional[BaseException] = None):
        with self._cond:
            if self._status is None:
                self._status = status
                self._exc = exc
                self._cond.notify_all()

    # ---- consumer side
    def cancel(self):
        """Stop this request at the next step boundary (or skip it while
        still queued). Emitted tokens stay readable; the stream finishes
        with status "cancelled"."""
        with self._cond:
            self._cancelled = True

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._cancelled

    @property
    def done(self) -> bool:
        with self._cond:
            return self._status is not None

    @property
    def status(self) -> Optional[str]:
        with self._cond:
            return self._status

    @property
    def error(self) -> Optional[BaseException]:
        """The stream's failure, once finished non-ok (None otherwise)."""
        with self._cond:
            return self._exc

    def token_count(self) -> int:
        with self._cond:
            return len(self._tokens)

    def get(self, i: int, timeout: Optional[float] = None) -> Optional[int]:
        """Token `i` (blocking up to `timeout` seconds), or None when the
        stream finished OK with <= `i` tokens; raises the stream's failure
        once `i` is past the delivered prefix."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        with self._cond:
            while True:
                if len(self._tokens) > i:
                    return self._tokens[i]
                if self._status is not None:
                    if self._exc is not None:
                        raise self._exc
                    return None
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise ServingTimeoutError(
                        f"token {i} not ready within {timeout}s")
                self._cond.wait(wait)

    def __iter__(self):
        i = 0
        while True:
            tok = self.get(i)
            if tok is None:
                return
            yield tok
            i += 1

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; return ALL tokens (raises the
        stream's failure instead, or `ServingTimeoutError` on a client-side
        timeout)."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        with self._cond:
            while self._status is None:
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise ServingTimeoutError(
                        f"generation not finished within {timeout}s")
                self._cond.wait(wait)
            if self._exc is not None:
                raise self._exc
            return list(self._tokens)


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "eos_id", "stream", "deadline",
                 "t_submit", "tokens_out", "slot", "pos")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int], deadline: Optional[float]):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.stream = TokenStream()
        self.deadline = deadline  # absolute perf_counter seconds, or None
        self.t_submit = time.perf_counter()
        self.tokens_out: List[int] = []
        self.slot: Optional[int] = None
        self.pos = 0  # next decode position (= prompt length after prefill)


class GenerationEngine(ServingEngine):
    """Continuous-batching greedy generation over a cache-aware model
    (`TransformerLM`-shaped: `init_cache` / `apply_prefill` /
    `apply_step`).

    Example:
        >>> import numpy as np
        >>> from bigdl_tpu_torch.models.transformer import TransformerLM
        >>> from bigdl_tpu_torch.serving import GenerationEngine
        >>> m = TransformerLM(32, embed_dim=16, n_layer=1, n_head=2,
        ...                   device="cpu")
        >>> with GenerationEngine(m, slots=2, max_len=16, max_new_tokens=3,
        ...                       device="cpu") as eng:
        ...     len(list(eng.stream(np.array([1, 2, 3]))))
        3

    slots : decode batch width, the streams decoded per step.
    max_len : KV cache depth per slot; a request must satisfy
        `len(prompt) + max_new_tokens <= max_len` at admission.
    max_new_tokens / eos_id : per-request defaults.
    prefill_batch : largest prefill batch bucket (`default_buckets`).
    seq_buckets : ascending prompt pad targets; None =
        `default_seq_buckets(max_len)`; `max_len` is always appended.
    device : where the engine runs; it must be the model's device.
        Default CUDA (see `resolve_device`).
    queue_capacity / admission / start : as `ServingEngine`.
    """

    def __init__(self, model, *, slots: int = 8, max_len: int = 256,
                 max_new_tokens: int = 64, eos_id: Optional[int] = None,
                 prefill_batch: int = 4,
                 seq_buckets: Optional[Sequence[int]] = None,
                 queue_capacity: int = 256, admission: str = "block",
                 device=None, start: bool = True):
        for attr in ("init_cache", "apply_prefill", "apply_step"):
            if not hasattr(model, attr):
                raise TypeError(
                    f"{type(model).__name__} has no {attr}(); "
                    "GenerationEngine needs a cache-aware autoregressive "
                    "model (models/transformer.py TransformerLM)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked to run on {self.device}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        super().__init__(max_batch_size=prefill_batch,
                         queue_capacity=queue_capacity, admission=admission,
                         start=False)
        self.model = model
        # an id past the vocabulary would index the embedding out of range,
        # which on CUDA is a device-side assert that ends the process's
        # CUDA context: reject it at admission
        self.vocab = getattr(model, "vocab", None)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.default_max_new_tokens = int(max_new_tokens)
        self.default_eos_id = eos_id
        if seq_buckets is None:
            seq_buckets = default_seq_buckets(self.max_len)
        else:
            seq_buckets = sorted(int(b) for b in seq_buckets)
            if not seq_buckets or seq_buckets[0] < 1 \
                    or len(set(seq_buckets)) != len(seq_buckets):
                raise ValueError(
                    f"seq_buckets must be distinct positive ints, got "
                    f"{seq_buckets}")
            if seq_buckets[-1] > self.max_len:
                raise ValueError(
                    f"seq_buckets cannot exceed max_len {self.max_len}, "
                    f"got {seq_buckets}")
            if seq_buckets[-1] < self.max_len:
                seq_buckets.append(self.max_len)
        self.seq_buckets = list(seq_buckets)
        self._cache = model.init_cache(self.slots, self.max_len)
        # slot table: owned by the dispatcher thread; _active mirrors it
        # under _slock for stats()/generation_stats() readers
        self._slot_req: List[Optional[_GenRequest]] = [None] * self.slots
        self._active = 0
        self._g = {"tokens": 0, "decode_steps": 0, "decode_slot_steps": 0,
                   "prefill_requests": 0, "prefill_batches": 0,
                   "slot_joins": 0, "slot_leaves": 0,
                   "prefill_s": 0.0, "decode_s": 0.0}
        if start:
            self.start()

    # ------------------------------------------------------------ admission
    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None) -> TokenStream:
        """Admit one greedy-decode request; returns its `TokenStream`.
        `prompt` is a 1-D array of 1-based token ids. `deadline_ms` bounds
        the request's queued life (admission and waiting for a free slot);
        once its prefill lands, a request runs to completion. Raises
        `ValueError` for an inadmissible request, plus the engine's
        admission errors."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.min() < 1:
            raise ValueError("token ids are 1-based; got a value < 1")
        if self.vocab is not None and prompt.max() > self.vocab:
            raise ValueError(f"token id {prompt.max()} exceeds the "
                             f"vocabulary size {self.vocab}")
        n_new = self.default_max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        if prompt.size + n_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({n_new}) "
                f"exceeds the cache depth max_len={self.max_len}")
        deadline = time.perf_counter() + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        req = _GenRequest(prompt, n_new,
                          self.default_eos_id if eos_id is None else eos_id,
                          deadline)
        self._admit(req)
        return req.stream

    def stream(self, prompt, **kw):
        """Generator convenience: yields tokens as they are produced."""
        yield from self.generate(prompt, **kw)

    # ------------------------------------------------------------ model calls
    def _prefill(self, cache, tokens, slot_ids, lengths) -> np.ndarray:
        dev = self.device
        logp, _ = self.model.apply_prefill(
            torch.from_numpy(tokens).to(dev), cache,
            slot_ids, torch.from_numpy(lengths).to(dev))
        return (logp.argmax(dim=-1) + 1).cpu().numpy()

    def _decode(self, cache, tokens, positions) -> np.ndarray:
        dev = self.device
        logp, _ = self.model.apply_step(torch.from_numpy(tokens).to(dev),
                                        cache,
                                        torch.from_numpy(positions).to(dev))
        return (logp.argmax(dim=-1) + 1).cpu().numpy()

    def warmup(self) -> int:
        """Run every prefill (batch bucket, seq bucket) shape and the
        decode step once against a scratch cache, so the first request
        pays no kernel build or library initialisation. Returns the number
        of shapes run."""
        scratch = self.model.init_cache(self.slots, self.max_len)
        n = 0
        with torch.inference_mode():
            for t_pad in self.seq_buckets:
                for b in self.buckets:
                    self._prefill(scratch, np.ones((b, t_pad), np.int32),
                                  np.zeros((b,), np.int32),
                                  np.ones((b,), np.int32))
                    with self._slock:
                        self._compiled.add((t_pad, b))
                    n += 1
            self._decode(scratch, np.ones((self.slots,), np.int32),
                         np.zeros((self.slots,), np.int32))
        return n + 1

    # ------------------------------------------------------------ loop
    def _seq_bucket(self, n: int) -> int:
        for b in self.seq_buckets:
            if b >= n:
                return b
        return self.seq_buckets[-1]  # unreachable: admission caps at max_len

    def _run(self):
        with torch.inference_mode():  # grad mode is per thread
            try:
                while True:
                    with self._lock:
                        while not self._q and self._active == 0 \
                                and not self._closing:
                            self._not_empty.wait()
                        if self._closing:
                            if not self._drain:
                                break
                            if not self._q and self._active == 0:
                                break
                    self._admit_into_slots()
                    # the dispatcher is the only writer of _active
                    if self._active:
                        self._decode_once()
            finally:
                self._abort_slots(EngineClosedError("engine closed"))

    def _admit_into_slots(self):
        """Move queued requests into free slots and prefill them, between
        decode steps and with no drain barrier."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free:
            return
        take: List[_GenRequest] = []
        dropped: List = []  # (req, status, exc), resolved outside the lock
        now = time.perf_counter()
        with self._lock:
            while self._q and len(take) < len(free):
                r = self._q.popleft()
                if r.stream.cancelled:
                    with self._slock:
                        self._n["cancelled"] += 1
                    dropped.append((r, "cancelled", None))
                elif r.deadline is not None and now >= r.deadline:
                    with self._slock:
                        self._n["timed_out"] += 1
                    dropped.append((r, "timeout", ServingTimeoutError(
                        "deadline lapsed in the serving queue "
                        f"({(now - r.t_submit) * 1e3:.1f} ms queued)")))
                else:
                    take.append(r)
            self._not_full.notify_all()
        for r, status, exc in dropped:
            r.stream._finish(status, exc)
        groups: Dict[int, List[_GenRequest]] = {}
        for r in take:
            groups.setdefault(self._seq_bucket(r.prompt.size),
                              []).append(r)
        for t_pad, rs in groups.items():
            for i in range(0, len(rs), self.max_batch_size):
                self._prefill_group(rs[i:i + self.max_batch_size],
                                    t_pad, free)

    def _prefill_group(self, rs: List[_GenRequest], t_pad: int,
                       free: List[int]):
        n = len(rs)
        bucket = self._bucket_for(n)
        slots = [free.pop(0) for _ in rs]
        tokens = np.ones((bucket, t_pad), np.int32)
        slot_ids = np.zeros((bucket,), np.int32)
        lengths = np.ones((bucket,), np.int32)
        for j, r in enumerate(rs):
            tokens[j, :r.prompt.size] = r.prompt
            slot_ids[j] = slots[j]
            lengths[j] = r.prompt.size
        for j in range(n, bucket):
            # bucket padding replicates the LAST request, including its
            # slot id: the padded row's commit rewrites identical K/V
            tokens[j] = tokens[n - 1]
            slot_ids[j] = slot_ids[n - 1]
            lengths[j] = lengths[n - 1]
        t0 = time.perf_counter()
        for r in rs:
            self.queue_wait.record(t0 - r.t_submit)
        try:
            first = self._prefill(self._cache, tokens, slot_ids, lengths)
        except Exception as e:  # contain the failure to this group
            self._prefill_failed(rs, slots, free, e)
            return
        t1 = time.perf_counter()
        with self._slock:
            hit = (t_pad, bucket) in self._compiled
            self._compiled.add((t_pad, bucket))
            self._n["batches"] += 1
            self._n["bucket_hits"] += int(hit)
            self._n["rows"] += bucket
            self._n["padded_rows"] += bucket - n
            self._g["prefill_requests"] += n
            self._g["prefill_batches"] += 1
            self._g["prefill_s"] += t1 - t0
            self._g["slot_joins"] += n
            self._g["tokens"] += n
            self._active += n
        for j, r in enumerate(rs):
            r.slot = slots[j]
            r.pos = r.prompt.size  # the first decode writes here
            self._slot_req[r.slot] = r
            tok = int(first[j])
            r.tokens_out.append(tok)
            r.stream._put(tok)
            if r.stream.cancelled:
                self._retire(r, "cancelled")
            elif tok == r.eos_id or r.max_new_tokens == 1:
                self._retire(r, "ok")

    def _prefill_failed(self, rs, slots, free, e: Exception):
        """A failed prefill fails its own group; its in-place cache writes
        may have landed partway, so the cache is reallocated and the active
        streams fail too (they lost their history)."""
        logger.warning("prefill failed (%r); reallocating the KV cache and "
                       "aborting active streams", e)
        free.extend(slots)
        with self._slock:
            self._n["failed"] += len(rs)
            self._n["batches"] += 1
        exc = ServingError(f"prefill failed: {e!r}")
        for r in rs:
            r.stream._finish("error", exc)
        self._reset_cache(exc)

    def _decode_once(self):
        """ONE fixed-shape decode step over all slots: active slots
        advance a token, inactive slots ride along at position 0."""
        active = [r for r in self._slot_req if r is not None]
        tokens = np.ones((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        for r in active:
            tokens[r.slot] = r.tokens_out[-1]
            positions[r.slot] = r.pos
        t0 = time.perf_counter()
        try:
            nxt = self._decode(self._cache, tokens, positions)
        except Exception as e:  # contain: fail the streams, keep serving
            logger.warning("decode step failed (%r)", e)
            # each active stream is counted "failed" once, by _retire
            self._reset_cache(ServingError(f"decode step failed: {e!r}"))
            return
        dt = time.perf_counter() - t0
        self.batch_sizes.record(len(active))
        with self._slock:
            self._g["decode_steps"] += 1
            self._g["decode_slot_steps"] += len(active)
            self._g["decode_s"] += dt
            self._g["tokens"] += len(active)
        for r in active:
            tok = int(nxt[r.slot])
            r.tokens_out.append(tok)
            r.pos += 1
            r.stream._put(tok)
            if r.stream.cancelled:
                self._retire(r, "cancelled")
            elif tok == r.eos_id \
                    or len(r.tokens_out) >= r.max_new_tokens:
                self._retire(r, "ok")

    def _retire(self, r: _GenRequest, status: str,
                exc: Optional[BaseException] = None):
        """A request leaves its slot between steps (EOS, token budget,
        cancellation, abort); the slot is free for the next admission."""
        self._slot_req[r.slot] = None
        with self._slock:
            self._active -= 1
            self._g["slot_leaves"] += 1
            key = {"ok": "completed", "error": "failed",
                   "cancelled": "cancelled", "timeout": "timed_out"}
            self._n[key.get(status, "failed")] += 1
        if status == "ok":
            self.latency.record(time.perf_counter() - r.t_submit)
        r.stream._finish(status, exc)

    def _reset_cache(self, exc: BaseException):
        """Fail every active stream (its KV history is gone) and allocate
        a fresh cache."""
        self._cache = self.model.init_cache(self.slots, self.max_len)
        for r in list(self._slot_req):
            if r is not None:
                self._retire(r, "error", exc)

    def _abort_slots(self, exc: BaseException):
        for r in list(self._slot_req):
            if r is not None:
                self._retire(r, "cancelled", exc)

    def _fail_queued(self, exc: BaseException):
        with self._lock:
            left = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
        with self._slock:
            self._n["cancelled"] += len(left)
        for r in left:
            r.stream._finish("cancelled", exc)

    # ------------------------------------------------------------ stats
    def generation_stats(self) -> Dict:
        """Token throughput, decode batch occupancy, prefill/decode time
        split and slot churn."""
        with self._slock:
            g = dict(self._g)
            active = self._active
        with self._lock:
            depth = len(self._q)
        elapsed = time.monotonic() - self._t0_mono
        occ = g["decode_slot_steps"] / (g["decode_steps"] * self.slots) \
            if g["decode_steps"] else None
        return {
            "slots": self.slots, "active_slots": active,
            "queue_depth": depth, "max_len": self.max_len,
            "tokens_total": g["tokens"],
            "tokens_per_sec": round(g["tokens"] / elapsed, 2)
            if elapsed > 0 and g["tokens"] else None,
            "decode_steps": g["decode_steps"],
            "decode_occupancy": round(occ, 4) if occ is not None else None,
            "prefill_requests": g["prefill_requests"],
            "prefill_batches": g["prefill_batches"],
            "prefill_s_total": round(g["prefill_s"], 4),
            "decode_s_total": round(g["decode_s"], 4),
            "slot_joins": g["slot_joins"],
            "slot_leaves": g["slot_leaves"],
        }


def greedy_decode_reference(model, prompt, max_new_tokens: int,
                            eos_id: Optional[int] = None) -> List[int]:
    """One-request-at-a-time full-recompute greedy decode: the serial
    baseline the continuous-batched engine must match token for token.
    Recomputes the whole sequence so far through `model.forward` for every
    emitted token. Returns the emitted 1-based tokens (EOS included when
    hit)."""
    toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
    out: List[int] = []
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            logp = model(torch.tensor([toks], device=model.device))
            nxt = int(logp[0, -1].argmax()) + 1
            out.append(nxt)
            toks.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
    return out
