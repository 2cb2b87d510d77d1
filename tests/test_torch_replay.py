"""Recorded replays of ``register_pair`` (``pipeline/replay.py``).

On the CPU the recorder runs with stand-in segments (they record no device
work; a replay notes which segment it replayed): the program a recording
keeps (segments cut at every span's ends, the spans' enters and exits with
their pairs), the counts it takes and gives back, the kernels' wrapper
counts it leaves alone, the cache's keys (recorded the second time one is
called), owners and their weights, capacity and the errors of a recording
(a capture's refusal runs eagerly, any other error is raised), the device
trace's kernels counted by each kernel's functions, and ``register_pair``
on the CPU at the small size of ``test_torch_pipeline.py``: eager on the
CPU, with state dicts and with draws from a generator, counting
``register.eager``; with the stand-in, a recording and a replayed call
under ``tracing()`` give the eager call's span tree and counts.

Marked ``chip`` (they skip without a card): ``register_pair`` replayed as
CUDA graphs against the eager chain on 8 pairs of the mixed pool at the
main path's full width, every field ``torch.equal``, with draws of their
own a pair, back to back; a flag tensor that flips between calls; a result
held across later calls; the span tree and counts of a traced replay, and
the kernels a device trace shows it ran, against the eager call's.
"""

import collections
import contextlib
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from bufferx_tpu_torch import cuda_build
from bufferx_tpu_torch.config import make_cfg
from bufferx_tpu_torch.data.modelnet import synthetic_pair_full_overlap
from bufferx_tpu_torch.pipeline import registration as treg
from bufferx_tpu_torch.pipeline import replay
from bufferx_tpu_torch.solver.ransac import HYPOTHESES
from bufferx_tpu_torch.tools.weights import load_snapshot
from bufferx_tpu_torch.utils import timers
from bufferx_tpu_torch.utils.timers import count, counters, span, spans, \
    tracing

# test_torch_pipeline.py's small size and weights (this file imports no JAX,
# so that its chip tests run on the card)
SNAP = os.path.join(os.path.dirname(__file__), "..", "snapshot",
                    "hard_moments_r4ft2")
SMALL = dict(
    patch=dict(desc_mode="moments", desc_pool="gated", num_fps=128,
               num_points_radius_estimate=160, num_points_per_patch=64),
    capacity=dict(max_points=2048, num_ransac_hypotheses=256,
                  ransac_chunk=128),
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads a process, as in test_torch_pipeline.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_store():
    """Each test starts with an empty span store and no counts (another
    file's traced or profiled calls in this process may have left some)."""
    spans()


class _Segment:
    def __init__(self, log, index):
        self.log, self.index = log, index

    def replay(self):
        self.log.append(self.index)


class StandIn:
    """Segments that record no device work; a replay appends the segment's
    index to ``log``. Records on any device, and takes the CUDA backend's
    rule on which errors are a capture's refusal."""

    log: list = []
    refused = staticmethod(replay.CudaGraphs.refused)

    def __init__(self, device):
        self.device = device
        self.made = 0
        self.open = False
        self.aborted = False

    @staticmethod
    def records_on(device):
        return True

    def scope(self):
        return contextlib.nullcontext()

    def settle(self, outputs=()):
        pass

    def begin(self):
        assert not self.open
        self.open = True

    def end(self):
        assert self.open
        self.open = False
        self.made += 1
        return _Segment(self.log, self.made - 1)

    def abort(self):
        self.open = False
        self.aborted = True


class _Kernel:
    def __init__(self):
        self.launches = 0


@pytest.fixture
def fake_kernel(monkeypatch):
    k = _Kernel()
    monkeypatch.setitem(cuda_build.KERNELS, "fake", k)
    return k


def _chain(kernel):
    """A chain with nested spans, counts and launches around its work."""
    def chain(x):
        kernel.launches += 1
        with span("bufferx.a", pairs=2, stream=True):
            kernel.launches += 2
            count("test.things", 3)
            with span("bufferx.b"):
                y = x * 2
        with span("bufferx.c", pairs=2):
            count("test.things", 1)
        return (y + 1,)
    return chain


def _tree(records) -> list:
    """[(name, pairs, parent's name)] in the order the spans opened."""
    by_id = {r.id: r for r in records}
    return [(r.name, r.pairs, by_id[r.parent].name if r.parent else None)
            for r in sorted(records, key=lambda r: r.id)]


def test_recording_cuts_at_every_span_end(fake_kernel):
    backend = StandIn("cpu")
    rec, out = replay.record(_chain(fake_kernel), (torch.ones(3),), backend)
    assert torch.equal(out[0], torch.full((3,), 3.0))
    assert rec.program == (0, ("bufferx.a", 2, True), 1, ("bufferx.b", None,
                                                          False),
                           2, None, 3, None, 4, ("bufferx.c", 2, False), 5,
                           None, 6)
    assert len(rec.segments) == backend.made == 7 and not backend.open
    assert rec.counts == {"test.things": 4}
    assert fake_kernel.launches == 0        # the wrapper counts as they were
    assert spans() == [] and counters() == {}


def test_a_recording_call_counts_its_eager_run_once(fake_kernel):
    """The call that records gives the eager run's spans, counts and
    wrapper launches, once: the recording adds none of them."""
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)
    chain = _chain(fake_kernel)
    trees = []
    for _ in range(2):                        # eager, then the recording
        with tracing():
            cache("k", (owner,), chain, (torch.ones(3),))
        trees.append(_tree(spans()))
        assert counters() == {"test.things": 4}
    assert trees[0] == trees[1] and len(trees[0]) == 3
    assert fake_kernel.launches == 2 * 3
    assert len(cache.entries) == 1


def test_play_gives_the_eager_tree_and_counts_and_no_launches(fake_kernel):
    """A replay's kernels run through no wrapper, so it adds nothing to
    the wrapper counts (a device trace counts them)."""
    chain = _chain(fake_kernel)
    with tracing():
        chain(torch.ones(3))
    eager = _tree(spans())
    eager_counts = counters()
    rec, _ = replay.record(chain, (torch.ones(3),), StandIn("cpu"))
    fake_kernel.launches = 0
    StandIn.log.clear()
    with tracing():
        replay.play(rec)
    assert _tree(spans()) == eager
    assert counters() == eager_counts == {"test.things": 4}
    assert StandIn.log == list(range(7))
    StandIn.log.clear()
    replay.play(rec)                      # tracing off: the segments alone
    assert StandIn.log == list(range(7)) and spans() == []
    assert counters() == {} and fake_kernel.launches == 0


def test_a_chain_that_fails_closes_its_segment(fake_kernel):
    def chain(x):
        fake_kernel.launches += 5
        with span("bufferx.a"):
            raise ValueError("no")

    backend = StandIn("cpu")
    with pytest.raises(ValueError):
        replay.record(chain, (torch.ones(1),), backend)
    assert backend.aborted and not backend.open
    assert fake_kernel.launches == 0 and timers._TRACER.local.recorder is None
    assert timers._TRACER.forced == 0


def test_a_recording_takes_its_own_threads_spans_alone():
    """Another thread's spans and counts (a prefetching loader's ingest)
    are not cut into the recording: they trace as they would without it."""
    backend = StandIn("cpu")
    rec = replay.Recorder(backend)

    def other():
        with span("bufferx.other", stream=True):
            count("test.other", 1)

    for on in (False, True):
        with timers.recording(rec):
            worker = threading.Thread(target=other)
            if on:
                with tracing():
                    worker.start()
                    worker.join()
            else:
                worker.start()
                worker.join()
        assert rec.program == [] and not rec.counts and backend.made == 0
        got = [(r.name, r.parent) for r in spans()]
        assert got == ([("bufferx.other", None)] if on else [])
        assert counters() == ({"test.other": 1} if on else {})


class _Owner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))


def test_replays_copy_inputs_and_clone_outputs():
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)

    def chain(x):
        return (x * owner.w,)

    a, b, c = (torch.full((3,), v) for v in (2.0, 3.0, 5.0))
    for x in (a, b):                          # eager, then the recording
        out, replayed = cache("k", (owner,), chain, (x,))
        assert not replayed and torch.equal(out[0], x)
    entry = cache.entries[("k", (id(owner),))]
    assert torch.equal(entry.inputs[0], b)
    out3, replayed = cache("k", (owner,), chain, (c,))
    assert replayed
    assert torch.equal(entry.inputs[0], c)          # the static input
    assert out3[0].data_ptr() != entry.outputs[0].data_ptr()
    # the stand-in records no work: its outputs are the recording's
    assert torch.equal(out3[0], entry.outputs[0])


def test_a_key_called_once_is_not_recorded():
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)

    def chain(x):
        return (x + 1,)

    for key in ("a", "b", "c"):
        out, replayed = cache(key, (owner,), chain, (torch.ones(1),))
        assert not replayed and torch.equal(out[0], torch.full((1,), 2.0))
    assert not cache.entries and len(cache.seen) == 3


def _edit(owner, how) -> float:
    """Change the owner's weight in one of the ways a caller can; returns
    its value after."""
    with torch.no_grad():
        if how == "in_place":                     # bumps its version
            owner.w.mul_(3.0)
        elif how == "load_state_dict":
            owner.load_state_dict({"w": torch.full((3,), 3.0)})
        elif how == "data":                       # another storage
            owner.w.data = torch.full((3,), 3.0)
        elif how == "to":                         # another dtype
            owner.to(torch.float64)
            return 1.0
        else:                                     # another object
            owner.w = torch.nn.Parameter(torch.full((3,), 3.0))
    return 3.0


@pytest.mark.parametrize("how", ["in_place", "load_state_dict", "data",
                                 "to", "new_parameter"])
def test_replays_rerecord_after_a_weight_edit(how):
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)

    def chain(x):
        return (x * owner.w,)

    x = torch.ones(3)
    assert [cache("k", (owner,), chain, (x,))[1] for _ in range(3)] == \
        [False, False, True]
    want = torch.full((3,), _edit(owner, how), dtype=owner.w.dtype)
    out, replayed = cache("k", (owner,), chain, (x,))
    assert not replayed                        # recorded again at once
    assert torch.equal(out[0], want)
    out, replayed = cache("k", (owner,), chain, (x,))
    assert replayed and torch.equal(out[0], want)


def test_dead_owners_are_forgotten_with_one_finalizer_each():
    owner, other = _Owner(), _Owner()
    cache = replay.Replays(backend=StandIn)

    def chain(x):
        return (x + 1,)

    x = torch.ones(1)
    for key in ("a", "a", "b"):
        cache(key, (owner,), chain, (x,))
    for _ in range(2):
        cache("a", (other,), chain, (x,))
    assert cache._watched == {id(owner), id(other)}
    assert len(cache.entries) == 2 and len(cache.seen) == 1
    gone = id(owner)
    del owner
    assert list(cache.entries) == [("a", (id(other),))]
    assert not cache.seen and cache._watched == {id(other)}
    assert all(gone not in k[1] for k in cache.refused)


def test_replays_keep_at_most_their_capacity():
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)

    def chain(x):
        return (x + 1,)

    x = torch.ones(1)
    for key in ("a", "a", "b", "b", "a", "c", "c"):
        cache(key, (owner,), chain, (x,))
    assert replay.CAPACITY == 2
    assert [k[0] for k in cache.entries] == ["a", "c"]


def test_calls_from_several_threads_take_turns():
    owner = _Owner()
    cache = replay.Replays(backend=StandIn)
    got = []

    def chain(x):
        return (x + 1,)

    def client():
        for _ in range(25):
            _out, replayed = cache("k", (owner,), chain, (torch.ones(2),))
            got.append(replayed)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=client) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert collections.Counter(got) == {False: 2, True: 8 * 25 - 2}
    assert len(cache.entries) == 1


def _failing(error):
    """A stand-in whose segments end in ``error`` on key "bad" alone."""
    class Failing(StandIn):
        key = None

        def end(self):
            if Failing.key == "bad":
                raise error
            return super().end()

    return Failing


def test_a_key_the_capture_refuses_runs_eagerly_and_takes_no_slot():
    owner = _Owner()
    backend = _failing(RuntimeError(
        "CUDA error: operation not permitted when stream is capturing"))
    cache = replay.Replays(backend=backend)
    calls = collections.Counter()

    def chain(x):
        calls["n"] += 1
        with span("bufferx.a"):
            pass
        return (x + 1,)

    x = torch.ones(1)
    backend.key = "bad"
    assert not cache("bad", (owner,), chain, (x,))[1]
    with pytest.warns(RuntimeWarning, match="stream is capturing"):
        out, replayed = cache("bad", (owner,), chain, (x,))
    assert not replayed and torch.equal(out[0], x + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(2):
            out, replayed = cache("bad", (owner,), chain, (x,))
            assert not replayed and torch.equal(out[0], x + 1)
    assert calls["n"] == 1 + 2 + 2           # eager, recording, 2 eager
    backend.key = None
    for key in ("a", "a", "b", "b"):
        cache(key, (owner,), chain, (x,))
    assert [k[0] for k in cache.entries] == ["a", "b"]
    assert [k[0] for k in cache.refused] == ["bad"]


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory while capturing"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    ValueError("no"),
], ids=["out_of_memory", "other_cuda_error", "not_a_runtime_error"])
def test_an_error_that_is_no_refusal_is_raised(error):
    owner = _Owner()
    backend = _failing(error)
    backend.key = "bad"
    cache = replay.Replays(backend=backend)

    def chain(x):
        return (x + 1,)

    x = torch.ones(1)
    cache("bad", (owner,), chain, (x,))
    with pytest.raises(type(error)):
        cache("bad", (owner,), chain, (x,))
    assert not cache.entries and not cache.refused
    assert timers._TRACER.local.recorder is None
    # the key starts over: eager, then another try at recording it
    assert not cache("bad", (owner,), chain, (x,))[1]
    with pytest.raises(type(error)):
        cache("bad", (owner,), chain, (x,))


def test_a_trace_s_kernels_are_counted_by_their_functions():
    """Kernel names as a device trace gives them (demangled, with their
    namespace, template and parameters) against each kernel's functions;
    the library's kernels count for none."""
    from bufferx_tpu_torch.geometry import spt_pallas  # noqa: F401
    from bufferx_tpu_torch.kernels import (  # noqa: F401
        conv_epilogue,
        conv_pallas,
        fps,
        hyp_score,
        strat_pallas,
    )

    names = [
        "fps_kernel(float const*, int, int, int, int*, int)",
        "void strat_kernel<3, true>(StratParams)",
        "moments_kernel(float const*, unsigned char const*, float*)",
        "cell_query_kernel(float const*, int)",
        "void (anonymous namespace)::conv_stack_kernel(float const*)",
        "void same_kernel<int, 4>(__nv_bfloat16 const*, Epilogue, void*)",
        "void padcl_kernel<long, 2>(__nv_bfloat16 const*, Epilogue)",
        "void amax_kernel<int>(__nv_bfloat16 const*, Epilogue)",
        "void cost_kernel<int>(__nv_bfloat16 const*)",
        "void hyp_score_kernel<true>(float const*, float const*)",
        "void hyp_score_kernel<false>(float const*, float const*)",
        "void at::native::elementwise_kernel<128, 4>(int, F)",
        "void at::native::unrolled_elementwise_kernel<"
        "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>",
        "my_fps_kernel(float const*)",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8",
    ]
    assert cuda_build.count_launches(names) == {
        "fps": 1, "strat": 1, "moments": 1, "cell_query": 1,
        "conv_stack": 1, "conv_epilogue": 4, "hyp_score": 2}


# ---- register_pair on the CPU ----------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = make_cfg("ModelNet40").override(**SMALL)
    statics = treg.PipelineStatics.from_config(cfg)
    sd = load_snapshot(SNAP)
    models = treg.build_models(statics, sd, "cpu")
    pairs = []
    for i in (0, 2):
        s, t, _T = synthetic_pair_full_overlap(np.random.RandomState(i), 2000)
        pairs.append((treg.prepare_cloud(s, cfg, seed=i, device="cpu"),
                      treg.prepare_cloud(t, cfg, seed=i, device="cpu"),
                      treg.make_draws(statics,
                                      torch.Generator().manual_seed(i),
                                      "cpu")))
    return dict(cfg=cfg, statics=statics, sd=sd, models=models, pairs=pairs)


def _calls(w, params, n=2, with_draws=True):
    src, tgt, draws = w["pairs"][0]
    with tracing():
        out = [treg.register_pair(
            w["cfg"], src, tgt, params,
            draws=draws if with_draws else None,
            generator=None if with_draws else torch.Generator().manual_seed(0),
            device="cpu") for _ in range(n)]
    records = spans()
    return out, records, counters()


def test_cpu_calls_are_eager(small):
    out, records, got = _calls(small, small["models"])
    assert got.get(treg.EAGER) == 2 and treg.REPLAYS not in got
    assert not treg._PAIR_REPLAYS.entries
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.fixture
def stand_in(monkeypatch):
    """``register_pair``'s cache with stand-in segments, which record on
    the CPU."""
    cache = replay.Replays(backend=StandIn)
    monkeypatch.setattr(treg, "_PAIR_REPLAYS", cache)
    return cache


@pytest.mark.parametrize("kind", ["state_dicts", "generator", "training"])
def test_what_a_replay_cannot_serve_stays_eager(small, stand_in, kind):
    params = small["models"]
    if kind == "state_dicts":
        params = small["sd"]
    elif kind == "training":
        params = treg.Models(*(m.train() for m in params))
    try:
        _out, _records, got = _calls(small, params,
                                     with_draws=kind != "generator")
    finally:
        for m in small["models"]:
            m.eval()
    assert got.get(treg.EAGER) == 2 and treg.REPLAYS not in got
    assert not stand_in.entries


def test_a_replayed_call_gives_the_eager_tree_and_counts(small, stand_in):
    """The eager call, the recording call and a replay: the same span tree
    and hypotheses; the first two count as eager, the third as a replay."""
    w = small
    src, tgt, draws = w["pairs"][0]
    calls = []
    for _ in range(3):
        with tracing():
            out = treg.register_pair(w["cfg"], src, tgt, w["models"],
                                     draws=draws, device="cpu")
        calls.append((out, _tree(spans()), counters()))
    assert len(stand_in.entries) == 1
    (eager, eager_tree, eager_counts), _recording, (got, tree, got_counts) \
        = calls
    assert tree == eager_tree == calls[1][1]
    assert [t[0] for t in tree].count("bufferx.candidates") == 3
    assert got_counts[HYPOTHESES] == eager_counts[HYPOTHESES] == 256
    assert calls[1][2][HYPOTHESES] == 256
    assert eager_counts[treg.EAGER] == calls[1][2][treg.EAGER] == 1
    assert got_counts[treg.REPLAYS] == 1 and treg.EAGER not in got_counts
    for a, b, c in zip(got, eager, calls[1][0]):  # the same inputs, so the
        assert torch.equal(a, b) and torch.equal(b, c)  # same outputs


def test_a_replay_reads_the_new_inputs_and_flags(small, stand_in):
    w = small
    (s0, t0, d0), (s1, t1, d1) = w["pairs"]
    for flags in (torch.tensor([True]), torch.tensor(False)):
        treg.register_pair(w["cfg"], s0, t0, w["models"], draws=d0,
                           is_aligned=flags, device="cpu")
    with tracing():
        treg.register_pair(w["cfg"], s1, t1, w["models"], draws=d1,
                           is_aligned=torch.tensor([False]), device="cpu")
    spans()
    assert counters()[treg.REPLAYS] == 1
    (entry,) = stand_in.entries.values()
    want = (*s1, *t1, *d1, torch.tensor([False]))
    assert len(entry.inputs) == len(want)
    for got, x in zip(entry.inputs, want):
        assert torch.equal(got, x)
    # a bool flag is a key of its own, each value another
    for flag in (True, True, False, False):
        treg.register_pair(w["cfg"], s1, t1, w["models"], draws=d1,
                           is_aligned=flag, device="cpu")
    assert {k[0][2] for k in stand_in.entries} == {True, False}


# ---- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the chip")
    from benchmark.generators.hard_mixed import settings
    from benchmark.generators.hardsynth import hard_pair
    from benchmark.seeding import random_state

    dev = torch.device("cuda", 0)
    cfg = make_cfg("ModelNet40").override(
        patch=dict(desc_mode="moments", desc_pool="gated"))
    statics = treg.PipelineStatics.from_config(cfg)
    models = treg.build_models(statics, load_snapshot(SNAP), dev)
    key = 20240101                     # the mixed pool's scene key
    params = dict(count=128, overlap=[0.3, 0.75], noise=[0.0, 0.00625, 0.0125],
                  density=[1.0, 1.0, 2.0, 4.0])
    pairs = []
    for i, (ov, nz, dr) in enumerate(settings(key, params)[:8]):
        s, t, _T = hard_pair(random_state(key, "hard_mixed", i),
                             family="eval", num_points=24000,
                             overlap_ratio=ov, noise=nz, density_ratio=dr)
        pairs.append((treg.prepare_cloud(s, cfg, seed=2 * i, device=dev),
                      treg.prepare_cloud(t, cfg, seed=2 * i + 1, device=dev),
                      treg.make_draws(statics,
                                      torch.Generator().manual_seed(50 + i),
                                      dev)))
    return dict(cfg=cfg, models=models, pairs=pairs, dev=dev)


def _eager(w, src, tgt, draws, flags=None):
    """``register_batch`` at B = 1: the eager chain, never replayed."""
    res = treg.register_batch(w["cfg"], [src], [tgt], w["models"],
                              draws=treg.stack_draws([draws]),
                              is_aligned=flags, device=w["dev"])
    return treg.RegistrationResult(*(x[0] for x in res))


def _assert_equal(got, want, what):
    for name, a, b in zip(treg.RegistrationResult._fields, got, want):
        assert torch.equal(a, b), f"{what}: {name} {a} != {b}"


@pytest.mark.chip
def test_replays_equal_the_eager_chain(card_world):
    w = card_world
    pairs = w["pairs"]
    want = [_eager(w, *p) for p in pairs]
    with tracing():
        warm = [treg.register_pair(w["cfg"], s, t, w["models"], draws=d,
                                   device=w["dev"]) for s, t, d in pairs[:2]]
        got = [treg.register_pair(w["cfg"], s, t, w["models"], draws=d,
                                  device=w["dev"]) for s, t, d in pairs]
        torch.cuda.synchronize()
    spans()
    got_counts = counters()
    assert got_counts.get(treg.EAGER) == 2
    assert got_counts.get(treg.REPLAYS) == len(pairs)
    _assert_equal(warm[0], want[0], "the eager call")
    _assert_equal(warm[1], want[1], "the recording call")
    for i, (g, e) in enumerate(zip(got, want)):
        _assert_equal(g, e, f"replay {i}")


@pytest.mark.chip
def test_a_flag_tensor_that_flips_and_a_held_result(card_world):
    w = card_world
    src, tgt, draws = w["pairs"][1]
    flags = [torch.tensor([b], device=w["dev"]) for b in (True, False)] * 2
    want = [_eager(w, src, tgt, draws, f) for f in flags[:2]]
    held = treg.register_pair(w["cfg"], src, tgt, w["models"], draws=draws,
                              is_aligned=flags[0], device=w["dev"])
    kept = [x.clone() for x in held]
    for i, f in enumerate(flags):
        got = treg.register_pair(w["cfg"], src, tgt, w["models"],
                                 draws=draws, is_aligned=f, device=w["dev"])
        _assert_equal(got, want[i % 2], f"flag {bool(f)}, call {i}")
    _assert_equal(held, kept, "a result held across later calls")


@pytest.mark.chip
def test_a_traced_replay_gives_the_eager_spans_counts_and_kernels(
        card_world):
    """The kernels are read from a device trace of each call: the eager
    call launches them through the wrappers, the replay through none."""
    from bufferx_tpu_torch.tools.trace_pair import kernel_launches

    w = card_world
    src, tgt, draws = w["pairs"][2]

    def traced(fn):
        cuda_build.reset_launch_counts()

        def call():
            with tracing():
                fn()
        _out, ran = kernel_launches(call)
        tree = _tree(spans())
        return tree, counters(), ran, {n: k.launches for n, k in
                                       cuda_build.KERNELS.items()}

    def pair():
        treg.register_pair(w["cfg"], src, tgt, w["models"], draws=draws,
                           device=w["dev"])

    for _ in range(2):                          # recorded (or held)
        pair()
    e_tree, e_counts, e_ran, e_wrapped = traced(
        lambda: treg.register_batch(w["cfg"], [src], [tgt], w["models"],
                                    draws=treg.stack_draws([draws]),
                                    device=w["dev"]))
    r_tree, r_counts, r_ran, r_wrapped = traced(pair)
    assert r_tree[1:] == e_tree[1:]                   # under the one root
    assert r_tree[0][:2] == e_tree[0][:2] == ("bufferx.register", 1)
    assert r_counts[HYPOTHESES] == e_counts[HYPOTHESES]
    assert r_counts[treg.REPLAYS] == 1
    assert r_ran == e_ran == e_wrapped
    assert all(e_ran[k] for k in ("fps", "strat", "moments",
                                  "conv_epilogue", "hyp_score"))
    assert not any(r_wrapped.values())
