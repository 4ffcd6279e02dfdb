"""LMSession — the LM serving loop as a reusable, resumable object.

Counterpart of `repro/serve/session.py` on one device, for every LM
family:

    session = LMSession("qwen3-1.7b", smoke=True, batch=4,
                        prompt_len=64, gen=32, device="cpu",
                        ckpt_dir=d, ckpt_every=8)
    session.start(resume=True)       # prefill — or restore mid-decode
    while session.remaining:
        session.decode_steps(4)      # any step granularity
    tokens = session.tokens_out()

so the Gateway can interleave decode steps with other workloads
(`LMDecodeWorkload` in gateway.py), and a preempted serving process
restarts from the last `--ckpt-every` checkpoint (`start(resume=True)`
reloads cache + tokens + step and continues decoding).

Prefill runs self- and cross-attention through kernel K4 on a card
(`models/layers.py::sdpa_any`); decode attention is plain PyTorch.

CONTINUOUS BATCHING: the decode step takes a per-row position vector,
so the padded batch's slots need not be in lockstep — `admit()`
prefills ONE new sequence (batch-1 prefill) and scatters its cache row
into a free slot mid-decode, and `evict(slot)` frees the row and
returns its tokens.  Slot occupancy is surfaced through
`repro_torch.obs` metrics (`lm.slots_active`, `lm.admitted`,
`lm.evicted`) when a registry is attached.

The checkpoint is {"cache", "tokens"} under step k via
train.checkpoint (atomic rename + LATEST pointer); k is the number of
decode steps already applied, so resumed decoding continues at position
S + k (checkpoints cover the uniform lockstep mode; per-slot admission
state is process-local).

Departures from the reference, none of which changes a result: the
session keeps only the weights cast for serving (the cast the
reference repeats inside every jitted step), draws and casts them one
layer at a time (`transformer.init(..., cast=)`), so the fp32 masters
of one layer at most are alive (a model whose masters do not fit the
card beside its serving weights still starts), and the decode step
updates the cache in place (the reference donates it).  `layers` cuts
the decoder's depth (the encoder's stays), for a model that does not
fit one card whole.

Tensor parallelism: with `group` (a torch.distributed process group,
one process per GPU) every rank of the group builds the same session
and makes the same calls.  The ranks form a data × model grid
(`launch.mesh.shared_grid(model_axis, group)`) under the layout
`pick_layout` gives (`layout`); each draws the same weights from the
seed and keeps its shard of each part as it is drawn
(`convert.shard_params`), holds its rows and its part of the cache,
and sees the whole batch's logits, so every rank takes the same tokens.
An admitted sequence's cache row is written by the rank that holds its
slot's row (`local_batch`: under 'dp_replicated' the rows are split
over every rank).  Decode
checkpoints are written per rank, under `rank<r>-of-<W>-model<M>/`;
resuming under another grid raises.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..obs import get_tracer, timer
from ..parallel import tp
from ..parallel.sharding import kv_layout, local_batch, pick_layout


def fake_prompts(cfg, B, S, seed: int, device="cpu"):
    """A synthetic prompt batch matching the family's input: token
    prompts [B, S], uniform over the vocabulary; encdec adds frame
    embeddings "enc_embeds" bf16 [B, S, d], standard normal; vlm has
    patch embeddings "embeds" bf16 [B, S, d] and "positions3" [B, 3, S]
    (arange in every component) instead of tokens.  Drawn from a CPU
    `torch.Generator` seeded with `seed` (the same prompts on every
    device).  They differ from the reference's `jax.random` draws: tests
    feed both packages the same numpy arrays instead."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.stub_frontend and cfg.family == "vlm":
        embeds = torch.randn((B, S, cfg.d_model), generator=gen)
        return {"embeds": embeds.to(torch.bfloat16).to(device),
                "positions3": torch.arange(S).expand(B, 3, S).to(device)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((B, S, cfg.d_model),
                                          generator=gen).to(torch.bfloat16)
    return {k: t.to(device) for k, t in batch.items()}


def _pairs(dst, src):
    """Matching leaves of two cache trees (nested dicts and lists), over
    the keys of `src` (an enc-dec prefill fills only "cross_kv")."""
    if isinstance(dst, dict):
        for k in src:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src, strict=True):
            yield from _pairs(d, s)
    else:
        yield dst, src


def seed_cache(cache, prefill_cache, S, offset: int = 0):
    """Copy prefill K/V (length S) into the front of the decode cache, in
    place; returns `cache`.  K/V leaves are [B, S, K, hd]; a Mamba state
    is copied whole.  With `offset` the decode cache's self-attention
    K/V begin at prompt position `offset` (a rank's block of positions
    where the cache is split along the sequence)."""
    for name, part in prefill_cache.items():
        for dst_layer, src_layer in zip(cache[name], part, strict=True):
            for key, src in src_layer.items():
                dst = dst_layer[key]
                if key not in ("k", "v"):
                    dst.copy_(src)
                    continue
                off = offset if name == "layers" else 0
                n = max(0, min(src.shape[1] - off, dst.shape[1]))
                dst[:, :n].copy_(src[:, off:off + n])
    return cache


def _scatter_row(dst, src, b: int):
    """Write a batch-1 cache leaf into row `b` of the live batch-B leaf,
    in place (continuous-batching admission).  The batch axis is located
    structurally: the unique axis where src is 1 and dst is B; every
    other axis matches because both are decode-shaped (same max_seq)."""
    if src.shape == dst.shape:          # B == 1: the row IS the cache
        dst.copy_(src)
        return dst
    ax = next(i for i in range(dst.dim())
              if src.shape[i] == 1 and dst.shape[i] != 1)
    dst.select(ax, b).copy_(src.squeeze(ax))
    return dst


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LMSession:
    """One batched generation: prefill once, then stepwise greedy decode.

    Parameters mirror `launch/serve.py`'s CLI.  `device` defaults to
    ``"cuda"`` and raises without a card; pass ``"cpu"`` to run the
    plain PyTorch path on the CPU.  `group` / `model_axis`: tensor
    parallelism, as the module says.
    """

    def __init__(self, arch: str, *, smoke: bool = False, batch: int = 4,
                 prompt_len: int = 64, gen: int = 32, max_seq: int = 0,
                 device="cuda", seed: int = 0, ckpt_dir: str = "",
                 ckpt_every: int = 0, metrics=None, layers: int = 0,
                 group=None, model_axis: int = 1):
        from ..configs import get_config, get_smoke_config
        from ..launch.mesh import shared_grid

        self.arch = arch
        self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if layers:
            self.cfg = self.cfg.scaled(n_layers=layers)
        self.device = resolve_device(device)
        self.B = batch
        self.S = prompt_len
        self.gen = gen
        self.max_seq = max_seq or (prompt_len + gen)
        self.grid = (None if group is None and model_axis == 1
                     else shared_grid(model_axis, group))
        self.layout = (None if self.grid is None
                       else pick_layout(self.cfg, self.grid))
        self._rows = (0, batch) if self.grid is None else local_batch(
            batch, self.grid, self.layout)
        self._kv_offset = 0
        if self.grid is not None and kv_layout(
                self.cfg, batch, self.max_seq, self.grid,
                self.layout) == "seq":
            self._kv_offset = (self.grid.model_rank
                               * (self.max_seq // self.grid.model))
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self._metrics = metrics         # optional obs.MetricsRegistry
        self._params = None
        self._decode = None
        self._cache = None
        self._tokens = None             # [B, 1] int64 on the device
        self._generated: list[np.ndarray] = []
        self.step_i = 0                 # decode steps already applied
        self.resumed_from: int | None = None
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        # continuous-batching slot state (uniform lockstep until the
        # first admit()/evict() call perturbs it)
        self._pos = None                # np int64 [B]: next write position
        self._active = [False] * batch  # admitted & not evicted
        self._budget = [0] * batch      # decode steps granted per slot
        self._taken = [0] * batch       # decode steps consumed per slot
        self._slot_tokens = {}          # slot -> [int] generated tokens
        self._prefill1 = None           # lazy batch-1 admission prefill
        self.admitted = 0
        self.evicted = 0
        self.flash_launches = 0         # K4 launches by this session
        self.prefill_collectives: dict = {}   # by kind, the batch prefill

    @contextlib.contextmanager
    def _counting_flash(self):
        before = ops.launches["flash"]
        try:
            yield
        finally:
            self.flash_launches += ops.launches["flash"] - before

    # ----------------------------------------------------------- lifecycle
    def start(self, *, resume: bool = False) -> int | None:
        """Prefill — or, with `resume=True` and a checkpoint present,
        restore cache/tokens/step and skip the prefill entirely.
        Returns the restored step (None for a fresh start)."""
        from ..convert import shard_params
        from ..models import transformer as T
        from .serve_step import cast_params_for_serving, make_decode

        with get_tracer().span("lm.init", arch=self.arch, batch=self.B):
            # weights, the decode step and K4's build (on a card) are
            # cold-start costs; a leaf span keeps them attributable
            dtype = getattr(torch, self.cfg.dtype)
            self._params = T.init(
                self.cfg, self.seed, self.device,
                cast=lambda part: cast_params_for_serving(part, dtype),
                shard=None if self.grid is None else (
                    lambda part: shard_params(part, self.cfg, self.grid)))
            self._decode = make_decode(self.cfg, self.device, grid=self.grid,
                                       batch=self.B, max_seq=self.max_seq)
            ops.prepare_flash(self.device)
            _sync(self.device)
        restored = self._try_restore() if resume else None
        if restored is None:
            self._prefill()
        else:
            self.resumed_from = self.step_i = restored
        self._init_slots(self.step_i)
        return self.resumed_from

    def _init_slots(self, at_step: int) -> None:
        """Every row starts occupied, in lockstep at position S+step —
        the uniform batch; admit()/evict() diverge from here."""
        self._pos = np.full(self.B, self.S + at_step, np.int64)
        self._active = [True] * self.B
        self._budget = [self.gen] * self.B
        self._taken = [at_step] * self.B
        toks = self._tokens.cpu().numpy()
        self._slot_tokens = {b: [int(toks[b, 0])] for b in range(self.B)}
        self._slots_gauge()

    def _slots_gauge(self) -> None:
        if self._metrics is not None:
            self._metrics.gauge("lm.slots_active").set(sum(self._active))

    def _prefill(self) -> None:
        from ..models import transformer as T
        from .serve_step import make_prefill

        with get_tracer().span("lm.build", batch=self.B,
                               prompt_len=self.S):
            batch = fake_prompts(self.cfg, self.B, self.S, self.seed,
                                 self.device)
            prefill = make_prefill(self.cfg, self.device, q_chunk=0,
                                   grid=self.grid)
        before = dict(tp.calls)
        with get_tracer().span("lm.prefill", arch=self.arch, batch=self.B,
                               prompt_len=self.S), timer() as t, \
                self._counting_flash():
            logits, prefill_cache = prefill(self._params, batch)
            _sync(self.device)
        self.prefill_seconds = t.seconds
        self.prefill_collectives = {k: n - before[k]
                                    for k, n in tp.calls.items()}
        with get_tracer().span("lm.cache_init", batch=self.B,
                               max_seq=self.max_seq):
            cache = T.init_cache(self.cfg, self.B, self.max_seq,
                                 device=self.device, grid=self.grid)
            self._cache = seed_cache(cache, prefill_cache, self.S,
                                     self._kv_offset)
        self._tokens = logits.argmax(dim=-1)[:, None]
        self._generated = [self._tokens.cpu().numpy().astype(np.int32)]

    def _try_restore(self) -> int | None:
        from ..models import transformer as T
        from ..train import checkpoint as ckpt

        if not self.ckpt_dir:
            return None
        where = self._ckpt_path()
        step = ckpt.latest_step(where)
        if step is None:
            self._check_grid_of_checkpoints()
            return None
        tree_like = {
            "cache": T.init_cache(self.cfg, self.B, self.max_seq,
                                  device="meta", grid=self.grid),
            "tokens": torch.empty((self.B, 1), dtype=torch.long,
                                  device="meta"),
        }
        tree, step = ckpt.restore(where, tree_like, step=step,
                                  device=self.device)
        self._cache = tree["cache"]
        self._tokens = tree["tokens"]
        # generation up to `step` happened in the previous process;
        # tokens_out() covers the resumed suffix only
        self._generated = [self._tokens.cpu().numpy().astype(np.int32)]
        return step

    def _ckpt_path(self) -> str:
        """This rank's checkpoint directory (`ckpt_dir` itself on one
        device)."""
        g = self.grid
        if g is None:
            return self.ckpt_dir
        return os.path.join(self.ckpt_dir,
                            f"rank{g.rank}-of-{g.size}-model{g.model}")

    def _check_grid_of_checkpoints(self) -> None:
        """Raise when `ckpt_dir` holds checkpoints of another grid (or of
        one device, or per rank when this session runs on one)."""
        if not os.path.isdir(self.ckpt_dir):
            return
        g = self.grid
        ours = "" if g is None else f"-of-{g.size}-model{g.model}"
        other = sorted(
            n for n in os.listdir(self.ckpt_dir)
            if (n.startswith("rank") and not (ours and n.endswith(ours)))
            or (n == "LATEST" and g is not None))
        if other:
            raise ValueError(
                f"{self.ckpt_dir} holds decode checkpoints of another grid "
                f"({', '.join(other[:4])}); a serving checkpoint resumes "
                f"only under the world and model axis that wrote it "
                f"(here {ours[1:] if g else 'one device'})")

    # -------------------------------------------------------------- decode
    @property
    def remaining(self) -> int:
        """Decode steps still owed to the hungriest live slot (``gen -
        step_i`` until admissions diverge budgets)."""
        if self._pos is None:           # start() not called yet
            return max(self.gen - self.step_i, 0)
        live = [self._budget[b] - self._taken[b]
                for b in range(self.B)
                if self._active[b] and self._taken[b] < self._budget[b]]
        return max(live, default=0)

    def decode_steps(self, k: int) -> int:
        """Run up to `k` greedy decode steps (bounded by `remaining`);
        checkpoints cache+tokens every `ckpt_every` steps.  Returns the
        number of steps actually run; the device has finished them when
        it returns, so the caller's timing covers real device work.

        Every step advances the WHOLE padded batch one token at each
        row's own position (rows past their budget still compute — the
        price of a static batch shape — but their tokens are not
        recorded, and their cache rows are re-seeded on admit())."""
        if self._decode is None:
            raise RuntimeError("LMSession.start() must run first")
        from ..train import checkpoint as ckpt

        n = min(max(k, 0), self.remaining)
        if n == 0:
            return 0
        with get_tracer().span("lm.decode", arch=self.arch, steps=n,
                               at_step=self.step_i), timer() as t, \
                self._counting_flash():
            for _ in range(n):
                pos = torch.from_numpy(self._pos).to(self.device)
                logits, self._cache = self._decode(
                    self._params, self._tokens, self._cache, pos)
                self._tokens = logits.argmax(dim=-1)[:, None]
                toks = self._tokens.cpu().numpy().astype(np.int32)
                self._generated.append(toks)
                for b in range(self.B):
                    if self._active[b] and self._taken[b] < self._budget[b]:
                        self._slot_tokens[b].append(int(toks[b, 0]))
                        self._taken[b] += 1
                # dead rows park at the last cache cell (their writes
                # are discarded on the next admission)
                self._pos = np.minimum(self._pos + 1, self.max_seq - 1)
                self.step_i += 1
                if (self.ckpt_dir and self.ckpt_every
                        and self.step_i % self.ckpt_every == 0):
                    ckpt.save(self._ckpt_path(), self.step_i,
                              {"cache": self._cache, "tokens": self._tokens})
            _sync(self.device)
        self.decode_seconds += t.seconds
        return n

    # ------------------------------------------------ continuous batching
    def slots(self) -> dict:
        """Occupancy snapshot: slot -> {active, pos, taken, budget}."""
        return {b: {"active": self._active[b],
                    "pos": None if self._pos is None else int(self._pos[b]),
                    "taken": self._taken[b],
                    "budget": self._budget[b]}
                for b in range(self.B)}

    def admit(self, *, seed: int | None = None,
              gen: int | None = None) -> int:
        """Join ONE new sequence to the running batch: prefill it at
        batch 1, scatter its K/V rows into the first free slot's cache
        rows, and start it at position S — the other slots' tokens are
        untouched (their rows are never written).  Returns the slot
        index; raises when no slot is free."""
        if self._decode is None:
            raise RuntimeError("LMSession.start() must run first")
        free = [b for b in range(self.B) if not self._active[b]]
        if not free:
            raise RuntimeError(
                f"no free slot (batch={self.B} all active) — evict first")
        slot = free[0]
        if seed is None:
            seed = self.seed + 1009 * (self.admitted + 1)
        with get_tracer().span("lm.admit", slot=slot, seed=seed), \
                timer() as t, self._counting_flash():
            row_cache, token = self._prefill_one(seed)
            lo, n = self._rows          # this rank's rows of the batch
            if lo <= slot < lo + n:
                for dst, src in _pairs(self._cache, row_cache):
                    _scatter_row(dst, src, slot - lo)
            self._tokens = self._tokens.clone()
            self._tokens[slot, 0] = token
            _sync(self.device)
        self.prefill_seconds += t.seconds
        self._pos[slot] = self.S
        self._active[slot] = True
        self._budget[slot] = self.gen if gen is None else max(int(gen), 0)
        self._taken[slot] = 0
        self._slot_tokens[slot] = [int(token)]
        self.admitted += 1
        if self._metrics is not None:
            self._metrics.counter("lm.admitted").inc()
        self._slots_gauge()
        return slot

    def evict(self, slot: int) -> np.ndarray:
        """Free a slot and return its generated tokens (prefill argmax
        first, then one per recorded decode step)."""
        if not (0 <= slot < self.B) or not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        out = np.asarray(self._slot_tokens[slot], np.int32)
        self._active[slot] = False
        self.evicted += 1
        if self._metrics is not None:
            self._metrics.counter("lm.evicted").inc()
        self._slots_gauge()
        return out

    def _prefill_one(self, seed: int):
        """Batch-1 prefill for admissions: returns (decode-shaped cache
        with batch 1, first generated token).  The prefill step is built
        once and reused for every admission."""
        from ..models import transformer as T
        from .serve_step import make_prefill

        if self._prefill1 is None:
            self._prefill1 = make_prefill(self.cfg, self.device, q_chunk=0,
                                          grid=self.grid)
        batch = fake_prompts(self.cfg, 1, self.S, seed, self.device)
        logits, prefill_cache = self._prefill1(self._params, batch)
        cache1 = T.init_cache(self.cfg, 1, self.max_seq, device=self.device,
                              grid=self.grid)
        cache1 = seed_cache(cache1, prefill_cache, self.S, self._kv_offset)
        token = int(logits.argmax(dim=-1)[0])
        return cache1, token

    # ----------------------------------------------------------- reporting
    def tokens_out(self) -> np.ndarray:
        """[B, steps+1] generated tokens (since resume, when resumed)."""
        return np.concatenate(self._generated, axis=1)

    def metrics(self) -> dict:
        steps = self.step_i - (self.resumed_from or 0)
        tok_s = (steps * self.B / self.decode_seconds
                 if self.decode_seconds > 0 else 0.0)
        return {
            "arch": self.arch,
            "batch": self.B,
            "prompt_len": self.S,
            "steps_done": self.step_i,
            "steps_total": self.gen,
            "resumed_from": self.resumed_from,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            "decode_tok_s": tok_s,
            "ms_per_step": (1e3 * self.decode_seconds / steps
                            if steps else 0.0),
            "admitted": self.admitted,
            "evicted": self.evicted,
            "slots_active": sum(self._active),
            "flash_launches": self.flash_launches,
        }
