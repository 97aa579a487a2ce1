"""CUDA graphs of a decode chain, captured once per chunk shape.

A serving decode runs every chunk at one fixed shape (``padded_chunks``,
``chunked_caption_ids``), so the launches of a chunk's prologue and of
each of its steps can be recorded once as CUDA graphs and replayed for
every later chunk: one graph launch in place of the tens of kernel
launches a step issues from Python.  ``DecodeGraphs`` is such a set for
one dict of weights and one step function; the ``Captioner`` owns one
and hands it to ``beam_decode`` (``graphs=``), which captures and replays
its chain through it.  Every other caller decodes eagerly.

The set holds, per chunk shape, the static input tensors that the
prologue graph reads (a bank chunk is gathered straight into them,
``gather``; any other batch is copied in, ``chain``) and the captured
chain.  The first chunk of a shape decodes eagerly on the set's own
stream, which warms what the capture then records, and its result is
the one returned.  All the graphs share one memory pool: a graph's
outputs that the next graph reads stay alive, what each leaves behind is
reused by the next capture, and the graphs of a chain replay in the
order they were captured, one chunk at a time (``claim``).  A capture
that raises (a step that reads a value on the host, say) leaves that
shape eager for the set's life.  The kernel wrappers' ``launches`` counts stay those of the
card: a capture counts nothing, and each replay counts the launches its
graph holds.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..model import kernel, tp
from ..utils.profiling import span

# the wrappers an LSTM decode step can launch, whose counts a replay keeps
_WRAPPERS = (kernel.attention_core, kernel.logit_tail, kernel.spatial_core,
             kernel.gates_lstm)


def available() -> bool:
    """Whether a graph may be captured or replayed here: no
    ``torch.export`` or ``torch.compile`` traces, no capture is under
    way, and no model axis is entered (a tensor-parallel step holds
    collectives)."""
    return not (torch.compiler.is_exporting()
                or torch.compiler.is_compiling()
                or (torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing())
                or tp.current() is not None)


def _counts(wrappers) -> List[Tuple[int, Dict[str, int]]]:
    return [(fn.launches, dict(fn.launches_by_route)) for fn in wrappers]


class _Graph:
    """One captured graph and the kernel launches it holds."""

    __slots__ = ("graph", "launches")

    def __init__(self, graph: "torch.cuda.CUDAGraph",
                 launches: List[Tuple[Callable, str, int]]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for fn, route, n in self.launches:
            fn.launches += n
            fn.launches_by_route[route] += n


class DecodeGraphs:
    """The CUDA graphs of the decodes of weights ``params`` through
    ``step_fn``, on the current CUDA device; ``replayed`` counts the
    decode steps run by a replay.  ``wrappers`` are the kernel wrappers
    the decode can launch (by default the LSTM step's), whose launch
    counts a replay adds."""

    def __init__(self, params: Dict[str, torch.Tensor], step_fn: Callable,
                 wrappers: Tuple[Callable, ...] = _WRAPPERS):
        self.params = params
        self.step_fn = step_fn
        self.wrappers = wrappers
        self.replayed = 0
        # chain key -> the captured chain, or None: its capture raised
        self.chains: Dict[tuple, object] = {}
        self._inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._lock = threading.RLock()
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self._released: Optional[torch.cuda.Event] = None

    def serves(self, params, step_fn) -> bool:
        return params is self.params and step_fn is self.step_fn

    def engages(self, params, step_fn, batch: Dict[str, torch.Tensor]
                ) -> bool:
        """A decode of ``params`` through ``step_fn`` over ``batch``
        runs through this set."""
        return (self.serves(params, step_fn) and batch["frames"].is_cuda
                and available())

    @contextlib.contextmanager
    def claim(self) -> Iterator[Optional["DecodeGraphs"]]:
        """The set for the calling thread's decode (its static inputs
        and graphs, until the block ends), or None while another thread
        decodes with it, whose decode then runs eagerly.  The claimant's
        stream waits for the work of the last one, which may have used
        another stream."""
        if not self._lock.acquire(blocking=False):
            yield None
            return
        try:
            if self._released is not None:
                torch.cuda.current_stream().wait_event(self._released)
            yield self
        finally:
            if self._stream is not None:
                self._released = torch.cuda.Event()
                self._released.record()
            self._lock.release()

    # -- static inputs ------------------------------------------------------

    @staticmethod
    def _signature(shapes: Dict[str, Tuple[tuple, torch.dtype, object]]
                   ) -> tuple:
        return tuple(sorted((k, tuple(s), d, str(dev))
                            for k, (s, d, dev) in shapes.items()))

    def _static(self, shapes) -> Dict[str, torch.Tensor]:
        sig = self._signature(shapes)
        got = self._inputs.get(sig)
        if got is None:
            with torch.inference_mode():
                got = {k: torch.empty(s, dtype=d, device=dev)
                       for k, (s, d, dev) in shapes.items()}
            self._inputs[sig] = got
        return got

    def gather(self, bank: Dict[str, torch.Tensor], rows: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """``rows`` of a resident bank gathered straight into the static
        inputs of their shape (``index_select`` with ``out=``)."""
        n = rows.shape[0]
        inputs = self._static({k: ((n,) + tuple(v.shape[1:]), v.dtype,
                                   v.device) for k, v in bank.items()})
        with torch.inference_mode():
            for k, v in bank.items():
                torch.index_select(v, 0, rows, out=inputs[k])
        return inputs

    # -- capture --------------------------------------------------------------

    def chain(self, key: tuple, batch: Dict[str, torch.Tensor],
              warm: Callable[[Dict[str, torch.Tensor]], object],
              build: Callable[[Dict[str, torch.Tensor]], object]):
        """(chain, first) for ``batch``, copied into the static inputs of
        its shapes.  The first time ``key`` comes at those shapes,
        ``warm(inputs)`` runs eagerly on the set's stream, so the lazy
        state of what it calls (the kernel library, cuBLAS's workspace
        for that stream) is made outside the graphs' pool, and its
        result is ``first``; then ``build(inputs)`` captures the chain.
        Later, ``first`` is None.  The chain is None where its capture
        raised: that shape stays eager for the set's life.  Every use of
        the set's stream begins by waiting for the caller's, so memory
        the warm-up leaves is not reused before the caller is done."""
        shapes = {k: (v.shape, v.dtype, v.device) for k, v in batch.items()}
        inputs = self._static(shapes)
        with torch.inference_mode():
            for k, v in batch.items():
                if v is not inputs[k]:       # a gathered chunk is there
                    inputs[k].copy_(v)
        key = key + self._signature(shapes)
        if key in self.chains:
            return self.chains[key], None
        if self._stream is None:
            self._stream = torch.cuda.Stream(batch["frames"].device)
            self._pool = torch.cuda.graph_pool_handle()
        with span("stvd.decode.capture"):
            self._stream.wait_stream(torch.cuda.current_stream())
            try:
                with torch.cuda.stream(self._stream), \
                        torch.inference_mode():
                    first = warm(inputs)
                try:
                    self.chains[key] = build(inputs)
                except RuntimeError:
                    self.chains[key] = None
            finally:
                torch.cuda.current_stream().wait_stream(self._stream)
        return self.chains[key], first

    def capture(self, fn: Callable[[], object]) -> Tuple[_Graph, object]:
        """``fn()`` captured as one graph on the set's stream and pool:
        the graph and ``fn``'s outputs (tensors of the pool, which each
        replay writes anew)."""
        graph = torch.cuda.CUDAGraph()
        before = _counts(self.wrappers)
        try:
            with torch.cuda.stream(self._stream), torch.inference_mode():
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            after = _counts(self.wrappers)
            for fn_, (n, routes) in zip(self.wrappers, before):
                fn_.launches = n
                fn_.launches_by_route.update(routes)
        launches = [(fn_, route, got - routes[route])
                    for fn_, (_, routes), (_, got_routes) in zip(
                        self.wrappers, before, after)
                    for route, got in got_routes.items()
                    if got != routes[route]]
        return _Graph(graph, launches), out
