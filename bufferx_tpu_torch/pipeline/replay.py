"""A chain of device work recorded once and replayed as CUDA graphs.

A chain is a function of tensors that returns tensors, with static shapes,
no read back to the host and no random draws of its own (the pipeline's
single pair, :func:`~bufferx_tpu_torch.pipeline.registration.register_pair`,
is one). Eagerly, the host queues each of its operations one at a time;
replayed, the whole chain costs the host a few graph launches.

:func:`record` runs the chain once under a :class:`Recorder`: it opens a
segment, and each time a span of the program
(:func:`~bufferx_tpu_torch.utils.timers.span`) opens or closes inside the
chain it closes the segment, notes the span's enter (its name, pairs and
whether it times the stream) or exit, and opens the next segment. It also
takes the host counts the chain counted
(:func:`~bufferx_tpu_torch.utils.timers.count`). :func:`play` replays a
:class:`Recording`: the segments in the order recorded, each recorded span
opened and closed around its segments (so, while tracing is on, the stage
spans time the stream and annotate the profile as they do eagerly), then
the counts counted again. The hand-written kernels' wrapper counts
(``KERNELS[...].launches``) see only the host's own launches: a recording
leaves them as they were, and a replay adds nothing to them
(:func:`~bufferx_tpu_torch.cuda_build.count_launches` reads the kernels a
replay ran from a device trace).

The segments come from a backend, a class built on a device, with
``records_on(device)``, ``scope()`` (the context a recording runs in),
``settle(outputs)`` (called after the chain's eager run, with its
outputs, and after a refused recording),
``begin()``, ``end()`` (the closed segment, which has ``replay()``),
``abort()`` and ``refused(exc)`` (whether an error of a recording is a
capture's refusal of the chain, after which the chain runs eagerly):
:class:`CudaGraphs` captures each segment as a CUDA graph, all into one
memory pool on a side stream. Any other backend (a test's stand-in) drives
the same logic on the CPU.

:class:`Replays` keeps a few recordings of one chain, each under a key its
caller gives and with the static inputs it reads and the outputs it
writes. A call with a key it holds copies the call's inputs into the
static ones, replays, and returns clones of the static outputs (a later
call does not overwrite a result a caller holds). The first call with a
key runs the chain eagerly; the second runs it eagerly inside the
backend's scope and records it (so a key seen once costs no recording).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import warnings
import weakref
from typing import NamedTuple

import torch

from bufferx_tpu_torch.cuda_build import KERNELS
from bufferx_tpu_torch.utils import timers

__all__ = ["CudaGraphs", "Recorder", "Recording", "Replays", "play",
           "record", "signature"]


class Recording(NamedTuple):
    """A recorded chain: its segments, and its program, the steps of a
    replay in order: an int replays that segment, a tuple ``(name, pairs,
    stream)`` opens a span, None closes the innermost open one."""
    segments: tuple
    program: tuple
    counts: dict      # host counter -> what the chain counted


class Recorder:
    """Cuts a chain into segments at its spans' ends while it runs inside
    :func:`~bufferx_tpu_torch.utils.timers.recording`, and takes its
    counts."""

    def __init__(self, backend):
        self.backend = backend
        self.counts: collections.Counter = collections.Counter()
        self.segments: list = []
        self.program: list = []

    def cut(self) -> None:
        """Close the open segment."""
        self.program.append(len(self.segments))
        self.segments.append(self.backend.end())

    @contextlib.contextmanager
    def span(self, name: str, pairs, stream: bool):
        self.cut()
        self.program.append((name, pairs, stream))
        self.backend.begin()
        yield
        self.cut()
        self.program.append(None)
        self.backend.begin()


def record(chain, inputs: tuple, backend) -> tuple:
    """(:class:`Recording`, outputs) of ``chain(*inputs)`` recorded into
    ``backend``'s segments. The kernels' wrapper counts are left as they
    were before."""
    before = {name: k.launches for name, k in KERNELS.items()}
    try:
        rec = Recorder(backend)
        with timers.recording(rec):
            backend.begin()
            try:
                outputs = chain(*inputs)
                rec.cut()
            except BaseException:
                backend.abort()
                raise
    finally:
        for name, k in KERNELS.items():
            k.launches = before.get(name, 0)
    return Recording(tuple(rec.segments), tuple(rec.program),
                     dict(rec.counts)), outputs


def play(rec: Recording) -> None:
    """Replay ``rec``: its segments in order inside its spans (which record
    only while tracing is on), then its counts."""
    open_spans = []
    for step in rec.program:
        if isinstance(step, int):
            rec.segments[step].replay()
        elif step is None:
            open_spans.pop().__exit__(None, None, None)
        else:
            cm = timers.span(*step)
            cm.__enter__()
            open_spans.append(cm)
    for name, n in rec.counts.items():
        timers.count(name, n)


class CudaGraphs:
    """Segments captured as CUDA graphs on a side stream, all into one
    memory pool (so they replay in the order captured). The capture errors
    only on unsafe calls of the capturing thread: another thread's work
    (a prefetching loader's copies) goes on."""

    @staticmethod
    def records_on(device: torch.device) -> bool:
        """A CUDA device, outside a capture already open on its stream."""
        return (device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing())

    @staticmethod
    def refused(exc: BaseException) -> bool:
        """Whether ``exc`` is a capture's refusal of an operation the
        chain made (one that reads back to the host, or another that a
        stream under capture does not take); never a lack of memory."""
        return (isinstance(exc, RuntimeError)
                and not isinstance(exc, torch.cuda.OutOfMemoryError)
                and "captur" in str(exc).lower())

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graph = None

    @contextlib.contextmanager
    def scope(self):
        """The block on the side stream, after the current stream's work;
        the current stream then waits for the side stream's. First, as
        ``torch.cuda.graph`` does, the collector runs (a recording whose
        owners are gone frees its pool) and the cached free memory goes
        back to the device: a capture cannot free cached blocks to make
        room for its pool."""
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            current.wait_stream(self.stream)

    def settle(self, outputs: tuple = ()) -> None:
        """After the chain's eager run on the side stream (which warms the
        libraries' handles and workspaces for it): its ``outputs`` go to
        the caller's stream, and the blocks it freed go back to the device,
        so that they are not held beside the recording's pool. The
        synchronize raises if the device was lost."""
        current = torch.cuda.current_stream(self.device)
        for x in outputs:
            x.record_stream(current)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self):
        graph, self._graph = self._graph, None
        with warnings.catch_warnings():
            # a segment between two span ends may hold no work
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            graph.capture_end()
        return graph

    def abort(self) -> None:
        graph, self._graph = self._graph, None
        if graph is not None:
            with contextlib.suppress(Exception):
                graph.capture_end()


def _tensors(tables) -> list:
    """The parameters and buffers in the modules' ``tables``."""
    return [t for d in tables for t in d.values() if t is not None]


def _state(tensors) -> list:
    """What a recording reads of its owners' weights: of each tensor, its
    object, version, storage, dtype and shape."""
    return [(id(t), t._version, t.data_ptr(), t.dtype, t.shape)
            for t in tensors]


class _Entry:
    """A recording with the static inputs it reads, the outputs it writes,
    and the state of its owners (the modules whose weights it reads) as it
    was recorded."""

    def __init__(self, recording, inputs, outputs, owners):
        self.recording, self.inputs, self.outputs = recording, inputs, outputs
        self.owners = tuple(weakref.ref(o) for o in owners)
        # the modules' own tables (which hold no reference to an owner)
        self.tables = [d for o in owners for m in o.modules()
                       for d in (m._parameters, m._buffers)]
        # the tensors are held, so that their ids name them alone
        self.tensors = _tensors(self.tables)
        self.state = _state(self.tensors)

    def serves(self, owners) -> bool:
        """Whether the owners are those recorded, with the same weights: an
        in-place edit (``load_state_dict`` among them) bumps a tensor's
        version, ``.data =`` and ``.to()`` give it another storage, and a
        new parameter is another object. Submodules added or removed
        since are not seen."""
        return (all(r() is o for r, o in zip(self.owners, owners))
                and _state(_tensors(self.tables)) == self.state)


def signature(tensors) -> tuple:
    """The shapes, dtypes and devices of ``tensors``: a part of a key."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


# the most recordings a Replays keeps (the least recently used dropped
# first): one recording of the main path's pair reserves about 0.8 GiB of
# graph pool on the card
CAPACITY = 2


class Replays:
    """Recordings of a chain under their callers' keys, at most
    :data:`CAPACITY`, with segments from ``backend(device)``. A key's
    recording, and what is known of it, is dropped when one of its owners
    is collected; a key whose recording the capture refused runs eagerly
    from then on. One call at a time: a recording's static buffers are
    shared by every call of its key."""

    def __init__(self, backend=CudaGraphs):
        self.backend = backend
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.seen: set = set()       # keys called once, not recorded
        self.refused: set = set()    # keys the capture refused
        self._watched: set = set()   # ids of owners with a finalizer
        # reentrant: the collector may run a finalizer inside a call
        self._lock = threading.RLock()

    def records_on(self, device: torch.device) -> bool:
        """Whether the segments can be recorded on ``device``."""
        return self.backend.records_on(device)

    def __call__(self, key, owners: tuple, chain, inputs: tuple) -> tuple:
        """(the outputs of ``chain(*inputs)``, whether a replay gave them).
        ``key`` holds everything the chain depends on besides the values of
        ``inputs`` and the ``owners``' weights; the ids of ``owners`` are
        added to it."""
        key = (key, tuple(id(o) for o in owners))
        with self._lock:
            return self._call(key, owners, chain, inputs)

    def _call(self, key, owners, chain, inputs) -> tuple:
        entry = self.entries.get(key)
        if entry is not None and entry.serves(owners):
            self.entries.move_to_end(key)
            for dst, x in zip(entry.inputs, inputs):
                dst.copy_(x)
            play(entry.recording)
            return tuple(x.clone() for x in entry.outputs), True
        if key in self.refused:
            return tuple(chain(*inputs)), False
        if entry is None and key not in self.seen:
            self._watch(owners)
            self.seen.add(key)
            return tuple(chain(*inputs)), False
        self.seen.discard(key)
        self.entries.pop(key, None)
        return self._record(key, owners, chain, inputs), False

    def _record(self, key, owners, chain, inputs) -> tuple:
        """The call's outputs, from the chain's eager run inside the
        backend's scope, which then records the chain on a copy of
        ``inputs``."""
        static = tuple(x.clone() for x in inputs)
        backend = self.backend(static[0].device)
        with backend.scope():
            outputs = tuple(chain(*inputs))
            backend.settle(outputs)
            try:
                recording, static_out = record(chain, static, backend)
            except Exception as exc:
                if not backend.refused(exc):
                    raise
                backend.settle()
                warnings.warn(f"the chain could not be recorded, so it "
                              f"runs eagerly: {exc}", RuntimeWarning,
                              stacklevel=4)
                self.refused.add(key)
                return outputs
        self.entries[key] = _Entry(recording, static, tuple(static_out),
                                   owners)
        while len(self.entries) > CAPACITY:
            self.entries.popitem(last=False)
        return outputs

    def _watch(self, owners) -> None:
        """One finalizer an owner, which forgets every key it is part of."""
        for o in owners:
            if id(o) not in self._watched:
                self._watched.add(id(o))
                weakref.finalize(o, self._forget, id(o))

    def _forget(self, owner_id: int) -> None:
        with self._lock:
            self._watched.discard(owner_id)
            for key in [k for k in self.entries if owner_id in k[1]]:
                del self.entries[key]
            self.seen = {k for k in self.seen if owner_id not in k[1]}
            self.refused = {k for k in self.refused if owner_id not in k[1]}
