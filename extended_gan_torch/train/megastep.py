"""K train steps a call (port of ``extended_gan_tpu/train/megastep.py``).

The JAX package scans K steps of a trainer's step body into one XLA
program, so the cost of dispatching a program is paid once per K steps. On
the card the port captures the K steps into one CUDA graph and replays it:
one launch on the host for the whole group in place of hundreds of kernel
launches a step. On the CPU the same body runs K times, eagerly.

Log rule, as in JAX: ``*_nd`` (num, denom) pairs are summed over the K
steps, and every other log keeps the last step's value.

On the card (:class:`Megastep`):

- The first group runs eagerly, as real steps, on the runner's stream. It
  is the warm-up that capture needs: it builds the optimizers' state, the
  cuBLAS and cuDNN handles of that stream, the kernels' cached launch
  plans and their shared-memory attributes. No step runs twice.
- Each later group is copied into static input buffers (a leading K axis)
  and replays the graph captured for its shapes: one graph for each
  distinct K (the epoch's shorter tail group) or batch, as JAX compiles
  one program for each. The graphs share one memory pool, which they
  replay in turn on one stream.
- Capture records without running, so a freshly captured graph is
  replayed at once for the group it was captured on.
- A Python-float learning rate is a constant of the captured optimizer
  kernels, so a change of any optimizer's learning rate (the scheduler's,
  at most once an epoch) drops the graphs, and the next group captures
  anew.
- Random draws from a ``torch.Generator`` on the card (DCGAN's channel
  dropout) advance across replays once the generator is registered with
  the graph (``generators``); the default generator is registered by torch.
- A capture or a replay that fails raises: there is no eager fallback.
- Under a data axis (``parallel.DataAxis``) the body's NCCL collectives
  (the gradient all-reduces, cross-rank BatchNorm, the global counts) are
  captured into the graph with the rest, so each rank replays its K steps
  and their collectives in one launch. The eager first group is every
  collective's first run, after the driver's broadcast of the weights
  made each communicator (NCCL cannot start one inside a capture); the
  launcher turns NCCL's asynchronous error handling off before the group
  starts (``parallel/launch.py``), as torch's notes on capturing NCCL ask.
  Every rank captures the same graphs in the same order: the groups'
  shapes, the learning rates and the padded tail are the same on every
  rank, since each runs the same loader or program list and the same
  scheduler on the same all-reduced losses. A gloo group on the card
  raises (``DataAxis.check_capturable``): its collectives run on the
  host, where no graph can record them.
- The kernel wrappers count a launch when their Python code runs, which a
  capture does once and a replay never: the runner takes back what the
  capture counted and adds it again at every replay
  (``ops.add_launches``), so ``ops.launch_counts()`` stays the number of
  launches the card ran; ``ops.plain_routes()`` the same.
"""

from __future__ import annotations

import types

import torch

from .. import ops


def aggregate_logs(stacked: list[dict]) -> dict:
    """The K steps' logs -> one dict: ``*_nd`` summed, the rest the last
    step's."""
    return {k: (torch.stack([s[k] for s in stacked]).sum(0)
                if k.endswith("_nd") else stacked[-1][k])
            for k in stacked[0]}


def _learning_rates(optimizers) -> tuple:
    return tuple(float(g["lr"]) for opt in optimizers
                 for g in opt.param_groups)


class _Graph:
    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class Megastep:
    """``megastep(*inputs) -> logs``: ``body(*row) -> logs`` for each row of
    the inputs, which share a leading K axis; the logs aggregated by
    :func:`aggregate_logs`. ``optimizers`` are the ones ``body`` steps (their
    learning rates key the captured graphs), ``generators`` the
    ``torch.Generator`` s on the card that it draws from, ``axis`` the data
    axis whose collectives ``body`` runs."""

    def __init__(self, body, *, optimizers=(), generators=(), axis=None):
        self.body = body
        self.axis = axis
        self.optimizers = tuple(optimizers)
        self.generators = tuple(generators)
        # keep each captured graph's node list (for ``graph.debug_dump``)
        self.keep_graphs = False
        self._graphs: dict[tuple, _Graph] = {}  # by the inputs' shapes
        self._lrs = None
        self._pool = None
        self._stream = None
        self._warm = False
        self.captures = 0
        self.replays = 0

    def eager(self, *inputs) -> dict:
        """The K steps one by one, on the current stream."""
        return aggregate_logs([self.body(*row) for row in zip(*inputs)])

    def __call__(self, *inputs) -> dict:
        device = inputs[0].device
        if device.type != "cuda":
            return self.eager(*inputs)
        if self.axis is not None:
            self.axis.check_capturable()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            logs = self._on_card(inputs)
        caller.wait_stream(self._stream)
        for v in logs.values():
            v.record_stream(caller)
        return logs

    def _on_card(self, inputs) -> dict:
        if not self._warm:
            self._warm = True
            return self.eager(*inputs)
        lrs = _learning_rates(self.optimizers)
        if lrs != self._lrs:
            self.reset()
            self._lrs = lrs
        shapes = tuple(tuple(x.shape) for x in inputs)
        entry = self._graphs.get(shapes)
        if entry is None:
            entry = self._graphs[shapes] = self._capture(inputs)
        else:
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x, non_blocking=True)
        entry.graph.replay()
        ops.add_launches(entry.launches)
        self.replays += 1
        return {name: v.clone() for name, v in entry.outputs.items()}

    def _capture(self, inputs) -> _Graph:
        static = [x.clone() for x in inputs]
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = ops.counters()
        # thread_local: the feed's thread pins and copies the next group
        # while this one is captured, which global mode would refuse
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            outputs = self.eager(*static)
        if self._pool is None:
            self._pool = graph.pool()
        after = ops.counters()
        launches = {name: n - before[name] for name, n in after.items()
                    if n != before[name]}
        ops.add_launches(launches, -1)  # recorded, not launched
        self.captures += 1
        return _Graph(graph, static, outputs, launches)

    @property
    def graphs(self):
        """The captured graphs, read-only, by the shapes of the inputs each
        was captured for: ``.graph`` (the ``CUDAGraph``), ``.launches`` (the
        kernel launches one replay makes, by counter name), ``.inputs`` and
        ``.outputs`` (its static tensors)."""
        return types.MappingProxyType(self._graphs)

    def reset(self):
        """Drops the captured graphs and their memory pool (a pool dies with
        its last graph, so a later capture cannot name it); the next group
        captures anew."""
        self._graphs.clear()
        self._pool = None
        self._lrs = None
