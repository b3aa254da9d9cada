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
  `hmm_host_dp` phase is a host job set) and the VB engine
  (`subclone_vb.vb_subclone`, after `vb_route` has counted an
  evaluation). It counts every call it sees, so the check can hold the
  counts against the program's own counters, records the (B, R, pad) of
  every #1 launch, and keeps a sample, drawn from the seed, of calls with
  their inputs and answers (of a VB call, a few genotype rows).
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


@dataclass
class Capture:
    """Scorer calls of the window: counts, #1's launches and samples."""

    rng: object
    host_keep: int = 384
    card_keep: int = 48
    vb_keep: int = 24
    vb_rows: int = 8
    on: bool = False
    launches: list = field(default_factory=list)     # (B, R, pad) of #1
    card_launches: int = 0      # launches of either kernel
    card_pairs: int = 0
    host_dp_calls: int = 0      # flank_banded_scores inside hmm_host_dp
    vb_evaluations: int = 0     # vb_route calls
    vb_unseen: int = 0          # of those with reads, no vb_subclone call seen
    host: Reservoir = None
    card: Reservoir = None
    vb: Reservoir = None
    _in_dp: int = 0
    _defaults: dict = field(default_factory=dict)
    _vb_pending: bool = False
    _undo: list = field(default_factory=list)

    def __post_init__(self):
        self.host = Reservoir(self.host_keep, self.rng)
        self.card = Reservoir(self.card_keep, self.rng)
        self.vb = Reservoir(self.vb_keep, self.rng)

    def _patch(self, obj, name, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def install(self, pairhmm_batch, native, timers, subclone_vb) -> None:
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
                self.host.offer(lambda: (args, raw))
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

    def _card(self, scorer, name):
        """A kernel's launch (tracks as one list) or, on a CPU, a plain twin
        (tracks as seven arguments), which is no launch."""
        launch = name.startswith("launch_")

        def card(*args, **kw):
            out = scorer(*args, **kw)
            if self.on:
                tracks = args[0] if launch else args[:7]
                pad = int(kw.get("pad", self._defaults["pad"]))
                B, R = (int(x) for x in tracks[0].shape)
                self.card_launches += launch
                self.card_pairs += B
                if name == "launch_kernel":
                    self.launches.append((B, R, pad))
                # the tracks and the answer are held, not copied, so the
                # window makes no copy of its own on the card
                self.card.offer(lambda: (list(tracks), pad,
                                         int(kw.get("nuc_prior", self._defaults["nuc_prior"])),
                                         out))
            return out

        return card

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

    def uninstall(self) -> None:
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo = []


__all__ = ["Spans", "Span", "Capture", "Reservoir"]
