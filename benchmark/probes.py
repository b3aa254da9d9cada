"""What the harness records from the program while the window runs, from
its own files, through the program's public seams (names in a module's
`__all__`, or the host extension's functions):

* `Spans` wraps `octopus_tpu_torch.utils.timers.phase` (every layer's
  phase), and the harness opens its own span around each `run_calling`; a
  span's self time is its length less its children's.
* `Capture` wraps the scorers underneath the likelihood layer: every
  launch of the pair-HMM kernels (`pairhmm_batch.launch_kernel`, #1, and
  `launch_lanes`; on a CPU their plain twins), the host extension's `flank_banded_scores` (the host
  DP, and the card scores' flank discount; a call inside the
  `hmm_host_dp` phase is a host job set), the VB engine
  (`subclone_vb.vb_subclone`, after `vb_route` has counted an
  evaluation) and the individual model's genotype reductions
  (`genotype_likelihoods.genotype_log_likelihoods_np`, float64 on the
  host, and `genotype_log_likelihoods_torch`, float32 on the device,
  which `genotype_log_likelihoods` reaches as module globals). It counts
  every call it sees, so the check can hold the counts against the
  program's own counters, records the (B, R, pad) of every #1 launch, and
  keeps samples drawn from the seed: of the pair-HMM's pairs a bounded
  number (`PairSample`, whatever the size of a launch), of VB calls a few
  genotype rows, of reductions a few genotype rows of some calls.
"""

from __future__ import annotations

import inspect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Span:
    name: str
    start: int                  # perf_counter_ns
    end: int = 0
    parent: int = -1
    child_ns: int = 0

    @property
    def self_ns(self) -> int:
        return self.end - self.start - self.child_ns


class Spans:
    """Nested spans of one thread, in memory."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._saved = None
        self._timers = None

    @contextmanager
    def span(self, name: str):
        index = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        self.spans.append(Span(name, time.perf_counter_ns(), parent=parent))
        self._stack.append(index)
        try:
            yield
        finally:
            s = self.spans[index]
            s.end = time.perf_counter_ns()
            self._stack.pop()
            if parent >= 0:
                self.spans[parent].child_ns += s.end - s.start

    def install(self, timers) -> None:
        """Record every `timers.phase` of the program as a span."""
        self._timers, self._saved = timers, timers.phase
        timers.phase = self.span

    def uninstall(self) -> None:
        if self._timers is not None:
            self._timers.phase = self._saved
            self._timers = None

    def self_seconds(self) -> dict:
        out: dict = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.self_ns / 1e9
        return out

    def self_intervals(self) -> list:
        """(start_ns, end_ns, name) of every stretch in which a span is the
        innermost one open, in time order."""
        children: dict = {}
        for i, s in enumerate(self.spans):
            children.setdefault(s.parent, []).append(i)
        out = []
        for i, s in enumerate(self.spans):
            cursor = s.start
            for c in children.get(i, []):
                cs = self.spans[c]
                if cs.start > cursor:
                    out.append((cursor, cs.start, s.name))
                cursor = max(cursor, cs.end)
            if s.end > cursor:
                out.append((cursor, s.end, s.name))
        out.sort()
        return out


class Reservoir:
    """A uniform sample of at most `size` items from a stream, drawn by
    `rng` (algorithm R)."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = make()


# pairs of the window's pair-HMM that the check compares, at most, on each
# side: ~5 s of the plain reference together on one host core
CARD_PAIRS = 8192
HOST_PAIRS = 8192


@dataclass
class Batch:
    """One call's pairs that `PairSample` holds: `data` the arrays or
    tensors of the call (rows first; the whole call's, by reference, until
    it is cut), `index` the rows of `data` still in the sample, `keys`
    their keys, `meta` what the check needs besides the rows."""

    data: list
    index: np.ndarray
    keys: np.ndarray
    meta: tuple

    @property
    def held(self) -> int:
        return int(self.data[0].shape[0])


class PairSample:
    """A uniform sample of at most `size` pairs from a stream of calls that
    score many pairs each (launches, host-DP calls), drawn by `rng`: every
    pair gets a key uniform on [0, 1), and the `size` pairs of least key
    are the sample (a bottom-k sample), so each pair of the window is
    compared with the same probability, min(1, size / pairs seen),
    whatever the sizes of the calls.

    A call with a pair under the threshold (1 until the sample is full,
    then the size-th least key or above it) is held whole, by reference,
    with no copy and no work on its device. Once the calls held hold more
    than `hold` pairs, the threshold drops to the size-th least key, the
    calls left with no pair under it are let go, and those that free the
    most rows are cut to their sampled rows (`take_rows`: on the card an
    index_select a tensor, queued, no copy back) until at most `hold` / 2
    rows are held. So the rows held never pass `hold` = 4 x `size` once a
    call returns."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.hold = size, rng, 4 * size
        self.threshold = 1.0
        self.batches: list = []
        self.rows_held = 0          # rows of `data` held
        self.held_max = 0
        self.cuts = 0               # calls cut to their sampled rows

    def offer(self, n: int, data, meta=()) -> None:
        """A call of n pairs: `data()` its row-first arrays, asked for only
        where some pair of the call enters the sample."""
        keys = self.rng.random(n)
        rows = np.flatnonzero(keys < self.threshold)
        if rows.size == 0:
            return
        self.batches.append(Batch(list(data()), rows, keys[rows], meta))
        self.rows_held += n
        if self.rows_held > self.hold:
            self._cut(self.hold // 2)
        self.held_max = max(self.held_max, self.rows_held)

    def _lower(self) -> None:
        """The threshold to the size-th least key held, and each call's
        rows to those at or under it; calls left with none are let go."""
        keys = np.concatenate([b.keys for b in self.batches]) \
            if self.batches else np.zeros(0)
        if keys.size > self.size:
            self.threshold = float(np.partition(keys, self.size - 1)[self.size - 1])
        kept = []
        for b in self.batches:
            live = b.keys <= self.threshold
            b.index, b.keys = b.index[live], b.keys[live]
            if b.index.size:
                kept.append(b)
        self.batches = kept
        self.rows_held = sum(b.held for b in kept)

    def _cut(self, target: int) -> None:
        self._lower()
        for b in sorted(self.batches, key=lambda b: b.index.size - b.held):
            if self.rows_held <= target:
                break
            if b.index.size < b.held:
                self.rows_held -= b.held - b.index.size
                b.data = [take_rows(a, b.index) for a in b.data]
                b.index = np.arange(b.index.size)
                self.cuts += 1

    def items(self) -> list:
        """(meta, [each array's sampled rows]) of every call in the
        sample, once the window has closed; the rows may still be on the
        card."""
        self._lower()
        return [(b.meta, [take_rows(a, b.index) for a in b.data])
                for b in self.batches]


def take_rows(a, rows: np.ndarray):
    """Rows `rows` of an array or tensor, on its own device."""
    if isinstance(a, torch.Tensor):
        index = torch.from_numpy(rows)
        if a.device.type != "cpu":
            index = index.to(a.device, non_blocking=True)
        return a.index_select(0, index)
    return a[rows]


def counts_genotypes(counts: np.ndarray) -> np.ndarray:
    """(G, P) haplotype indices of (G, H) haplotype multiplicities, the
    form `genotype_log_likelihoods_torch` takes a genotype in."""
    counts = np.rint(np.asarray(counts)).astype(np.int64)
    H = counts.shape[1]
    return np.stack([np.repeat(np.arange(H), row) for row in counts]) \
        if len(counts) else np.zeros((0, 0), np.int64)


@dataclass
class Capture:
    """Scorer calls of the window: counts, #1's launches and samples."""

    rng: object
    host_pairs: int = HOST_PAIRS
    card_pairs_kept: int = CARD_PAIRS
    vb_keep: int = 24
    vb_rows: int = 8
    gl_keep: int = 256          # host reductions kept
    gl_card_keep: int = 8       # device reductions kept, held by reference
    gl_rows: int = 4            # genotype rows of each kept reduction
    on: bool = False
    launches: list = field(default_factory=list)     # (B, R, pad) of #1
    card_launches: int = 0      # launches of either kernel
    card_pairs: int = 0
    host_dp_calls: int = 0      # flank_banded_scores inside hmm_host_dp
    vb_evaluations: int = 0     # vb_route calls
    vb_unseen: int = 0          # of those with reads, no vb_subclone call seen
    gl_calls: int = 0           # reductions seen, host and device
    host: PairSample = None
    card: PairSample = None
    vb: Reservoir = None
    gl_host: Reservoir = None
    gl_card: Reservoir = None
    _in_dp: int = 0
    _defaults: dict = field(default_factory=dict)
    _vb_pending: bool = False
    _undo: list = field(default_factory=list)

    def __post_init__(self):
        self.host = PairSample(self.host_pairs, self.rng)
        self.card = PairSample(self.card_pairs_kept, self.rng)
        self.vb = Reservoir(self.vb_keep, self.rng)
        self.gl_host = Reservoir(self.gl_keep, self.rng)
        self.gl_card = Reservoir(self.gl_card_keep, self.rng)

    def _patch(self, obj, name, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def install(self, pairhmm_batch, native, timers, subclone_vb,
                genotype_likelihoods) -> None:
        """Wrap the seams; install after `Spans.install`, so that the phase
        this wraps is the spans' one where they are on."""
        params = inspect.signature(pairhmm_batch.pairhmm_scores).parameters
        self._defaults = {k: params[k].default for k in ("pad", "nuc_prior")}
        for name in ("launch_kernel", "launch_lanes", "pairhmm_scores_plain",
                     "pairhmm_scores_lanes_plain"):
            self._patch(pairhmm_batch, name,
                        self._card(getattr(pairhmm_batch, name), name))
        flank = native.flank_banded_scores
        phase = timers.phase

        def host(*args):
            raw = flank(*args)
            if self.on:
                self.host_dp_calls += self._in_dp > 0
                n, L, W, pad, nuc = (int(x) for x in args[:5])
                self.host.offer(n, lambda: self._host_rows(n, L, W, args, raw),
                                (L, W, pad, nuc))
            return raw

        @contextmanager
        def phase_seen(name):
            dp = name == "hmm_host_dp"
            self._in_dp += dp
            try:
                with phase(name):
                    yield
            finally:
                self._in_dp -= dp

        route, engine = subclone_vb.vb_route, subclone_vb.vb_subclone

        def vb_route(device, elements):
            if self.on:
                self._vb_close()
                self.vb_evaluations += 1
                self._vb_pending = elements > 0
            return route(device, elements)

        def vb_subclone(lnl, alpha0, resp_init, n_iter=50):
            out = engine(lnl, alpha0, resp_init, n_iter=n_iter)
            if self.on:
                self._vb_pending = False
                self.vb.offer(lambda: self._vb_rows(lnl, alpha0, resp_init,
                                                    n_iter, out))
            return out

        self._patch(native, "flank_banded_scores", host)
        self._patch(timers, "phase", phase_seen)
        self._patch(subclone_vb, "vb_route", vb_route)
        self._patch(subclone_vb, "vb_subclone", vb_subclone)
        self._install_reductions(genotype_likelihoods)

    @staticmethod
    def _host_rows(n, L, W, args, raw) -> list:
        """The host DP call's ten arrays and its answers, rows first."""
        arrays = [np.asarray(a).reshape(n, L) if k < 2 else
                  np.asarray(a).reshape(n, W) if k < 7 else
                  np.asarray(a).reshape(n) for k, a in enumerate(args[5:15])]
        return arrays + [np.frombuffer(raw, np.int32)]

    def _card(self, scorer, name):
        """A kernel's launch (tracks as one list) or, on a CPU, a plain twin
        (tracks as seven arguments), which is no launch."""
        launch = name.startswith("launch_")

        def card(*args, **kw):
            out = scorer(*args, **kw)
            if self.on:
                tracks = args[0] if launch else args[:7]
                pad = int(kw.get("pad", self._defaults["pad"]))
                nuc = int(kw.get("nuc_prior", self._defaults["nuc_prior"]))
                B, R = (int(x) for x in tracks[0].shape)
                self.card_launches += launch
                self.card_pairs += B
                if name == "launch_kernel":
                    self.launches.append((B, R, pad))
                # held by reference: the window makes no copy on the card
                self.card.offer(B, lambda: [*tracks, out], (pad, nuc))
            return out

        return card

    def _install_reductions(self, gl) -> None:
        """Wrap the two reductions `genotype_log_likelihoods` reaches as
        module globals. A kept host call copies a few genotype rows, the
        haplotypes they hold and their answers on the host; a kept device
        call holds its tensors by reference, and its rows are drawn now and
        read once the window has closed."""
        host_np, device_torch = (gl.genotype_log_likelihoods_np,
                                 gl.genotype_log_likelihoods_torch)

        def reduce_np(lnL, genotypes, *args, **kw):
            out = host_np(lnL, genotypes, *args, **kw)
            if self.on:
                self.gl_calls += 1
                self.gl_host.offer(lambda: self._gl_host_rows(lnL, genotypes, out))
            return out

        def reduce_torch(lnL, counts, ploidy, *args, **kw):
            out = device_torch(lnL, counts, ploidy, *args, **kw)
            if self.on:
                self.gl_calls += 1
                self.gl_card.offer(lambda: {
                    "lnl": lnL, "counts": counts, "out": out,
                    "rows": self._gl_draw(int(counts.shape[0]))})
            return out

        self._patch(gl, "genotype_log_likelihoods_np", reduce_np)
        self._patch(gl, "genotype_log_likelihoods_torch", reduce_torch)

    def _gl_draw(self, G: int) -> np.ndarray:
        return np.sort(self.rng.choice(G, min(G, self.gl_rows), replace=False))

    def _gl_host_rows(self, lnL, genotypes, out) -> dict:
        """A few rows of one host reduction: their genotypes over the
        haplotypes they hold, those haplotypes' lnL and the answers."""
        genotypes = np.asarray(genotypes)
        rows = self._gl_draw(len(genotypes))
        haps, local = np.unique(genotypes[rows], return_inverse=True)
        return {"lnl": np.array(np.asarray(lnL)[haps], np.float64),
                "genotypes": local.reshape(len(rows), -1),
                "out": np.array(np.asarray(out)[rows], np.float64)}

    def _vb_rows(self, lnl, alpha0, resp_init, n_iter, out):
        """A few genotype rows of one VB call, copied to the host."""
        G = int(lnl.shape[0])
        rows = np.sort(self.rng.choice(G, min(G, self.vb_rows), replace=False))
        index = torch.as_tensor(rows, device=lnl.device)
        elbo = out[0]
        return {"lnl": lnl.index_select(0, index).cpu().numpy(),
                "alpha0": alpha0.cpu().numpy(),
                "seeds": int(resp_init.shape[0]), "n_iter": int(n_iter),
                "elbo": elbo.index_select(0, index).double().cpu().numpy()}

    def _vb_close(self) -> None:
        self.vb_unseen += self._vb_pending
        self._vb_pending = False

    def finish(self) -> None:
        """Close the window's counts."""
        self._vb_close()

    def reductions(self) -> list:
        """The kept reductions' rows on the host, once the window has
        closed: {"lnl" (H, R) float64 of the haplotypes the rows hold,
        "genotypes" (rows, P) into them, "out" (rows,), "device"}."""
        items = [dict(item, device=False) for item in self.gl_host.items]
        for item in self.gl_card.items:
            rows = torch.from_numpy(item["rows"]).to(item["counts"].device)
            genotypes = counts_genotypes(
                item["counts"].index_select(0, rows).cpu().numpy())
            haps, local = np.unique(genotypes, return_inverse=True)
            items.append({
                "lnl": item["lnl"][torch.from_numpy(haps).to(item["lnl"].device)]
                .double().cpu().numpy(),
                "genotypes": local.reshape(genotypes.shape),
                "out": item["out"].index_select(0, rows).double().cpu().numpy(),
                "device": True})
        return items

    def uninstall(self) -> None:
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo = []


__all__ = ["Spans", "Span", "Capture", "Reservoir", "PairSample", "Batch",
           "take_rows", "counts_genotypes", "CARD_PAIRS", "HOST_PAIRS"]
