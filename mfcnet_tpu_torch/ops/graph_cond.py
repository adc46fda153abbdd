"""A step captured as one CUDA graph, with data-dependent branches kept on
the card (``csrc/graph_cond.cu``).

:class:`StepGraph` captures a function of static tensors once and replays
it: the counterpart of one jitted JAX program (the tracker's
``fused_dispatch``). :func:`run_if` is the counterpart of ``lax.cond``
inside it: ``run_if(flag, body, orelse)`` runs ``body()`` when the 0-dim
bool tensor ``flag`` is true and ``orelse()`` (where given) when it is not.

- Outside a capture (the CPU, or an eager call on the card) the flag is read
  on the host and the branch runs eagerly: the plain version.
- During :meth:`StepGraph.capture` each branch becomes an IF node of the
  graph (``mfc_graph_if_begin`` / ``mfc_graph_if_end``; ``orelse`` on the
  negated flag): a one-thread kernel reads the flag on the card and sets
  the node's condition, and each replay runs the branch only when it is
  set. A branch may hold a ``run_if`` of its own (:data:`MAX_DEPTH` deep):
  the node nests in the branch's body. Each depth's branches are captured
  on a stream of its own, whose allocations go to a memory pool that lives
  as long as the graph. Each node's kernel also counts on the card how
  often its branch ran.

A branch writes its results into tensors made before it (``copy_``,
``fill_``); what it allocates is read only inside it and by the branches
it holds.

Counts. The port's counts of launches (``ops/_build.py::COUNTERS``: every
wrapper's ``LAUNCHES``, the decode's ``TIER_COUNTS``) are kept in Python,
which a replay never runs. A capture therefore records what it counted
outside the branches and what each branch counted outside the branches it
holds, and takes both out of the counts again: each
:meth:`StepGraph.replay` adds the first, and :func:`drain` (called where
the tracker fetches results) adds each branch's times the runs of that
branch that the card counted. :data:`LAUNCHES` counts the condition kernel
the same way.
"""

from __future__ import annotations

import weakref

import torch

from mfcnet_tpu_torch.ops._build import COUNTERS, counted, kernel_lib

#: condition-kernel launches since the last :func:`reset_launches`
LAUNCHES = counted({"graph_if": 0})
#: IF nodes one capture may hold (the slots of its run counter)
MAX_NODES = 8
#: how deep IF nodes may nest (a stream and a memory pool each)
MAX_DEPTH = 2
#: what ``mfc_graph_if_begin`` returns on a stream that is not capturing
NOT_CAPTURING = 30001

#: the capture under way (one at a time, as CUDA graphs allow in a process)
_ACTIVE = None
#: captured graphs whose replays :func:`drain` has not counted yet
_LIVE = weakref.WeakSet()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _snapshot():
    return [dict(d) for d in COUNTERS]


def _delta(before):
    """What the counts gained since ``before``: {(counter, key): n}."""
    out = {}
    for i, d in enumerate(COUNTERS):
        old = before[i] if i < len(before) else {}
        for k, v in d.items():
            if v != old.get(k, 0):
                out[i, k] = v - old.get(k, 0)
    return out


def _minus(a, parts):
    out = dict(a)
    for part in parts:
        for ik, v in part.items():
            out[ik] = out.get(ik, 0) - v
    return {ik: v for ik, v in out.items() if v}


def _split(total, nodes, parents):
    """(what one replay counts outside the branches, what each branch
    counts outside the branches it holds), from what the whole capture
    counted (``total``), what each IF node's branch counted with its
    nested ones (``nodes``) and the node each nests in (``parents``, None
    at the top)."""
    own = [_minus(d, [c for c, p in zip(nodes, parents) if p == i])
           for i, d in enumerate(nodes)]
    return _minus(total, [d for d, p in zip(nodes, parents)
                          if p is None]), own


def _add(delta, times: int = 1):
    for (i, k), v in delta.items():
        COUNTERS[i][k] += v * times


def _check(rc, what):
    if rc == NOT_CAPTURING:
        raise RuntimeError(f"{what}: the stream is not capturing a graph")
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def run_if(flag, body, orelse=None):
    """``body()`` when the 0-dim bool tensor ``flag`` is true, else
    ``orelse()`` where given. Outside a capture the flag is read on the
    host (one read); during :meth:`StepGraph.capture` the branches are IF
    nodes (see the module)."""
    cap = _ACTIVE
    if cap is not None:
        cap._add_if(flag, body, orelse)
    elif bool(flag):
        body()
    elif orelse is not None:
        orelse()


def drain():
    """Count the replays of every live captured graph since the last call:
    each branch's counts by the runs the card counted. Reads the run
    counters from the card (one small copy a graph that was replayed);
    does nothing when none was."""
    for g in list(_LIVE):
        g.drain()


class StepGraph:
    """A function of static tensors captured as one CUDA graph on
    ``device``: :meth:`capture` once, then :meth:`replay` per step. The
    function's inputs are tensors it reads where they live (fill them in
    place before each replay) and its outputs are tensors that every replay
    overwrites (copy them out before the next). A failed capture raises:
    a host synchronization inside the function, or a copy from host memory,
    is refused by the card while it captures."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = None
        self._body_streams = []
        #: the branches' memory pools, one a depth
        self.pools = []
        self._own = []      # per IF node: its branch's counts, nested out
        self._parent = []   # per IF node: the node it nests in, or None
        self._stack = []    # the nodes whose branches are being captured
        self._main = None   # counts of one replay outside the branches
        self._runs = None   # (MAX_NODES,) int64 on the card
        self._pending = 0
        self.replays = 0

    def capture(self, fn):
        """Capture ``fn()`` (nothing runs) and return its outputs, the
        tensors each replay writes."""
        global _ACTIVE
        if self.graph is not None:
            raise RuntimeError("StepGraph: already captured")
        if self.device.type != "cuda":
            raise ValueError(f"StepGraph on {self.device}: CUDA graphs run "
                             "on the card only")
        kernel_lib()  # build before the capture, not during it
        dev = self.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        self._runs = torch.zeros(MAX_NODES, dtype=torch.int64,
                                 device=self.device)
        capture_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        with torch.cuda.device(dev):
            # allocations on a branch stream go to a pool of their own: the
            # graph's pool serves its own capture stream only
            for _ in range(MAX_DEPTH):
                stream = torch.cuda.Stream(self.device)
                pool = torch.cuda.graph_pool_handle()
                with torch.cuda.stream(stream):
                    torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
                weakref.finalize(self, torch._C._cuda_releasePool, dev, pool)
                self._body_streams.append(stream)
                self.pools.append(pool)
            _ACTIVE = self
            try:
                with torch.cuda.graph(graph, stream=capture_stream):
                    out = fn()
            finally:
                _ACTIVE = None
                for pool in self.pools:
                    torch._C._cuda_endAllocateToPool(dev, pool)
                total = _delta(before)
                _add(total, -1)  # a capture launches nothing
        self._main, self._own = _split(total, self._own, self._parent)
        self.graph = graph
        _LIVE.add(self)
        return out

    def _add_if(self, flag, body, orelse):
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise ValueError("run_if: the flag must be one bool")
        self._add_node(flag, body, False)
        if orelse is not None:
            self._add_node(flag, orelse, True)

    def _add_node(self, flag, body, negate):
        i, depth = len(self._own), len(self._stack)
        if i >= MAX_NODES:
            raise RuntimeError(f"StepGraph: more than {MAX_NODES} IF nodes")
        if depth >= MAX_DEPTH:
            raise RuntimeError(f"StepGraph: IF nodes nested deeper than "
                               f"{MAX_DEPTH}")
        outer = torch.cuda.current_stream(self.device)
        body_stream = self._body_streams[depth]
        lib = kernel_lib()
        _check(lib.mfc_graph_if_begin(
            flag.data_ptr(), self._runs.data_ptr() + 8 * i, int(negate),
            outer.cuda_stream, body_stream.cuda_stream),
            "mfc_graph_if_begin")
        LAUNCHES["graph_if"] += 1
        self._own.append({})
        self._parent.append(self._stack[-1] if self._stack else None)
        self._stack.append(i)
        before = _snapshot()
        try:
            with torch.cuda.stream(body_stream):
                body()
        finally:
            self._stack.pop()
            _check(lib.mfc_graph_if_end(body_stream.cuda_stream),
                   "mfc_graph_if_end")
        self._own[i] = _delta(before)

    def replay(self):
        """One replay on the device's current stream."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        _add(self._main)
        self._pending += 1
        self.replays += 1

    def drain(self):
        """See :func:`drain`."""
        if not self._pending:
            return
        runs = self._runs.tolist()
        self._runs.zero_()
        for own, n in zip(self._own, runs):
            _add(own, n)
        self._pending = 0
