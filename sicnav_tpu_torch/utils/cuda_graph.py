"""Replay a function as CUDA graphs, captured once per input signature.

A batched control step is ~4e5 small kernels that the host would
dispatch one by one; captured once, the card replays them from a few
graph launches. ``GraphCache`` keeps one capture per signature of the
inputs (see ``signature``). On a miss it clones the inputs into static
buffers, captures the function on them in a private memory pool and
replays it once for the call's result; on a hit it copies the inputs into
the buffers and replays. Either way the caller gets fresh clones of the
graph's outputs, which the next replay overwrites, so a caller may keep
what it was handed across calls. The inputs are read, never aliased.

The captured function must be capturable: no host read of a device
value, no host data copied to the device, no memory that a library
allocates for itself. ``capture`` creates the CUDA libraries' handles
first (a handle's creation allocates, which capture cannot hold) and
raises where capture fails: there is no eager fallback.

A loop of identical iterations inside the function (the IPM's) runs
through ``repeat``: under capture its iteration becomes a graph of its
own, replayed once per iteration, so capture and instantiation pay for
one iteration instead of all of them: both cost host time by the kernel,
more than launching it does.

With ``utils.tracing`` on, the cache counts ``graph_captures`` and
``graph_replays`` (replays of a graph captured by an earlier call; the
capturing call's own replay is not one), and runs the copy-in, the
replay and the clone-out inside the spans the caller names.
"""

from __future__ import annotations

import contextlib

import torch

from sicnav_tpu_torch.utils import tracing


def flatten(tree):
    """(leaves, structure) of a tree of tuples, lists and NamedTuples; the
    structure is hashable and ``unflatten`` inverts it."""
    leaves = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(c) for c in x))
        leaves.append(x)
        return None

    return leaves, walk(tree)


def unflatten(structure, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, kids = s
        kids = [build(k) for k in kids]
        return kind(*kids) if hasattr(kind, "_fields") else kind(kids)

    return build(structure)


def tree_map(fn, tree):
    leaves, structure = flatten(tree)
    return unflatten(structure, [fn(x) for x in leaves])


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


def signature(args, key=()):
    """The key of ``args``' graph: the tree's structure, each tensor's
    shape, dtype and device, every other leaf (which must be hashable),
    and the caller's ``key`` (what the function closes over)."""
    leaves, structure = flatten(args)
    return (structure,
            tuple((tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x)
                  else ("leaf", x) for x in leaves),
            key)


def warm_libraries(device):
    """Create the cuBLAS and cuSOLVER handles of this thread and of the
    autograd engine's thread for ``device`` with tiny calls, under the
    current linear-algebra route: a batched and a single LU with its
    solve, and the gradient of a matrix product."""
    a = torch.eye(2, device=device).expand(2, 2, 2).contiguous()
    for m in (a, a[0]):
        lu, piv, _ = torch.linalg.lu_factor_ex(m)
        torch.linalg.lu_solve(lu, piv, m[..., :1])
    x = torch.ones(2, device=device)
    torch.func.grad(lambda v: torch.dot(v, v @ a[0]))(x)
    torch.cuda.synchronize(device)


class _Segments:
    """A capture under way: the graphs captured so far, each with the
    times a replay runs it, in one private memory pool (the graphs replay
    in the order they were captured, so a later one may take memory that
    an earlier one freed)."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.open = None

    def begin(self):
        self.open = torch.cuda.CUDAGraph()
        self.open.capture_begin(pool=self.pool)

    def end(self, times: int = 1):
        graph, self.open = self.open, None
        graph.capture_end()
        self.graphs.append((graph, times))

    def replay(self):
        for graph, times in self.graphs:
            for _ in range(times):
                graph.replay()


_capturing = None       # the _Segments of the capture under way


def repeat(body, state, times: int):
    """``state = body(state)``, ``times`` times. Under ``capture`` the
    first pass is captured with what came before it, the second as a graph
    of its own that ends by copying its result into ``state``'s tensors,
    and replays run that graph ``times - 1`` times: a loop of identical
    iterations is captured once, not ``times`` times. ``body`` must launch
    the same kernels on every pass and return a tree of ``state``'s
    structure."""
    if times <= 0:
        return state
    state = body(state)
    seg = _capturing
    if seg is None or times == 1:
        for _ in range(times - 1):
            state = body(state)
        return state
    seg.end()
    seg.begin()
    for buf, x in zip(flatten(state)[0], flatten(body(state))[0]):
        buf.copy_(x)
    seg.end(times - 1)
    seg.begin()
    return state


def capture(fn, args):
    """Capture ``fn(*args)`` as CUDA graphs, on the device of the first
    tensor in ``args`` and in one private memory pool; returns (the
    outputs, the replay). One graph, but for each loop that ``fn`` runs
    through ``repeat``: the loop's iteration is a graph of its own. Capture
    runs on a side stream, which waits for the work queued before it."""
    global _capturing
    device = next(x.device for x in flatten(args)[0] if torch.is_tensor(x))
    warm_libraries(device)
    with torch.cuda.device(device):
        seg = _Segments()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            seg.begin()
            _capturing = seg
            try:
                out = fn(*args)
            finally:
                _capturing = None
                seg.end()
        torch.cuda.current_stream().wait_stream(stream)
    return out, seg.replay


class GraphCache:
    """One capture per input signature, kept as long as the cache.

    ``cache(fn, args, key, spans)`` returns ``fn(*args)``, replayed from
    the graph of ``signature(args, key)``; ``fn`` must compute the same
    thing for every call that shares a signature. ``capture_fn`` (default
    ``capture``) takes (fn, static args) and returns (static outputs,
    replay); a plain call in its place runs the bookkeeping without a
    card."""

    def __init__(self, capture_fn=capture):
        self._capture = capture_fn
        self._graphs = {}

    def __len__(self):
        return len(self._graphs)

    def __call__(self, fn, args, key=(), spans=()):
        sig = signature(args, key)
        entry = self._graphs.get(sig)
        fresh = entry is None
        if fresh:
            static = tree_map(_clone, args)
            out, replay = self._capture(fn, static)
            entry = self._graphs[sig] = (flatten(static)[0], out, replay)
            tracing.count("graph_captures")
        else:
            tracing.count("graph_replays")
        buffers, out, replay = entry
        with contextlib.ExitStack() as spans_open:
            for name in spans:
                spans_open.enter_context(tracing.span(name))
            if not fresh:
                for buf, x in zip(buffers, flatten(args)[0]):
                    if torch.is_tensor(x):
                        buf.copy_(x)
            replay()
            return tree_map(_clone, out)
