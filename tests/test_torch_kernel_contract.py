"""The port's one kernel launch contract (``ops/_build.py``), on the CPU:
the ctypes signatures read from the ``extern "C"`` prototypes of
``csrc/*.cu`` against the hand-written lists they replaced, the launch path
on a stub library, the one tensor check, the one launch count and the
plan cache.  Nothing is compiled."""

import contextlib
import ctypes
import ctypes.util
import types

import pytest
import torch

from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.parallel import dryrun

I, LL, D, P = ctypes.c_int, ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p
INT_P = ctypes.POINTER(ctypes.c_int)

# (argtypes, restype) of each function as the wrappers bound it by hand
# before the prototypes became the only signature; the stream is the last
# c_void_p of a launcher
HAND_WRITTEN = {
    "gbt_hist_launch": ([P] * 6 + [I] * 12 + [P], I),
    "gbt_hist_max_active_clusters": ([I] * 3 + [INT_P], I),
    "gbt_hist_max_cells": ([], I),
    "gbt_route_launch": ([P, I, I] + [P] * 4 + [I] * 3 + [P] + [I] * 12 + [P], I),
    "gbt_split_launch": ([P] * 10 + [LL] * 3 + [P] * 2 + [I] * 5 + [D, I, P], I),
    "gbt_split_max_warps": ([], I),
    "gbt_grad_launch": ([P] * 7 + [LL, P, LL] + [P] * 5 + [I] * 3 + [LL, I, P], I),
    "gbt_leaves_launch": ([P] * 7 + [LL] + [I] * 3 + [LL, D, P], I),
    "lstm_encoder_launch": ([P] * 14 + [I] * 8 + [P], I),
    "lstm_encoder_max_active_clusters": ([I] * 7 + [INT_P], I),
}
ARITY = {"gbt_hist_launch": 19, "gbt_hist_max_active_clusters": 4, "gbt_hist_max_cells": 0, "gbt_route_launch": 24,
         "gbt_split_launch": 23, "gbt_split_max_warps": 0, "gbt_grad_launch": 21, "gbt_leaves_launch": 14,
         "lstm_encoder_launch": 23, "lstm_encoder_max_active_clusters": 8}
KERNEL_KEYS = ["gbt_hist", "gbt_route", "gbt_split", "gbt_grad", "gbt_leaves", "lstm_encoder"]


def _parsed():
    out = {}
    for source in _build.KERNELS.values():
        out.update(_build.signatures((_build.CSRC / source).read_text()))
    return out


def _is_pointer(t) -> bool:
    return t is ctypes.c_void_p or issubclass(t, ctypes._Pointer)


@pytest.mark.parametrize("name", sorted(HAND_WRITTEN))
def test_prototype_signature_equals_the_hand_written_list(name):
    restype, argtypes = _parsed()[name]
    want, want_restype = HAND_WRITTEN[name]
    assert len(argtypes) == len(want) == ARITY[name]
    assert restype is want_restype
    for k, (got, hand) in enumerate(zip(argtypes, want)):
        if _is_pointer(hand):
            assert got is ctypes.c_void_p, (name, k)
        else:
            assert got is hand, (name, k)


def test_every_extern_c_function_is_pinned_and_every_launcher_counted():
    assert sorted(_parsed()) == sorted(HAND_WRITTEN)
    assert list(_build.launches) == list(_build.plan_hits) == list(_build.plan_misses) == KERNEL_KEYS
    assert sorted(_build.KERNELS) == ["gbt_hist", "gbt_route", "gbt_split", "gbt_tree", "lstm_encoder"]


def test_a_pointer_parameter_takes_byref_out_parameters():
    # a parsed pointer parameter is a c_void_p, which takes ctypes.byref as
    # the hand-written POINTER(c_int) did (the out-parameter ``int* active``)
    libc = _build.bind(ctypes.CDLL(ctypes.util.find_library("c")),
                       'extern "C" void* memset(void* dst, int value, long long n);')
    active = ctypes.c_int(7)
    libc.memset(ctypes.byref(active), 0, ctypes.sizeof(active))
    assert active.value == 0


@pytest.mark.parametrize("text,what", [
    ('extern "C" int x_launch(const float* a, cudaStream_t stream, int n) {}', "cudaStream_t last"),
    ('extern "C" int y(float a);', "no ctypes type"),
])
def test_signatures_refuse_what_the_contract_does_not_hold(text, what):
    with pytest.raises(ValueError, match=what):
        _build.signatures(text)


def _stand_in_for_the_card(monkeypatch, state):
    """Stand in for the current CUDA device (``state.current``), its current
    stream's handle (``state.stream``) and ``torch.cuda.device``, which
    records each switch in ``state.switches`` and makes the device current
    inside its block."""

    @contextlib.contextmanager
    def device(index):
        state.switches.append(index)
        before, state.current = state.current, index
        try:
            yield
        finally:
            state.current = before

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: state.current, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: state.stream, raising=False)


@pytest.fixture
def stub(monkeypatch):
    """A library whose ``fake_launch(const float*, int, cudaStream_t)``
    records its calls and returns ``stub.rc``; the current device (0) and
    stream (1234) are stood in for, and the count is a fresh one."""
    lib = types.SimpleNamespace(calls=[], rc=0, current=0, stream=1234, switches=[])

    def fake_launch(*args):
        lib.calls.append((lib.current, *args))
        return lib.rc

    lib.fake_launch = fake_launch
    _build.bind(lib, 'extern "C" int fake_launch(const float* x, int n, cudaStream_t stream) { return 0; }')
    _stand_in_for_the_card(monkeypatch, lib)
    monkeypatch.setattr(_build, "launches", {"fake": 0})
    return lib


CUDA0 = torch.device("cuda", 0)


def test_launch_appends_the_stream_and_counts(stub):
    _build.launch(stub.fake_launch, CUDA0, 0, 3)
    assert stub.calls == [(0, 0, 3, 1234)] and _build.launches == {"fake": 1}


@pytest.mark.parametrize("args", [(0,), (0, 3, 5)])
def test_launch_refuses_a_wrong_argument_count_before_the_call(stub, args):
    with pytest.raises(TypeError, match="fake_launch takes 2 arguments"):
        _build.launch(stub.fake_launch, CUDA0, *args)
    assert stub.calls == [] and _build.launches == {"fake": 0}


def test_launch_raises_naming_the_kernel_and_the_error(stub):
    stub.rc = 700
    with pytest.raises(RuntimeError, match="fake kernel launch failed: cudaError_t 700"):
        _build.launch(stub.fake_launch, CUDA0, 0, 3)
    assert len(stub.calls) == 1 and _build.launches == {"fake": 0}


@pytest.mark.parametrize("current,switches", [(0, []), (1, [0])])
def test_launch_makes_its_device_current_only_where_it_is_not(stub, current, switches):
    # ctypes launches on the thread's current device: the launch runs on
    # cuda:0 either way, and the caller's device is current again after it
    stub.current = current
    _build.launch(stub.fake_launch, CUDA0, 0, 3)
    assert stub.calls == [(0, 0, 3, 1234)] and stub.switches == switches and stub.current == current


def test_launch_reads_the_current_stream_at_every_call(stub):
    _build.launch(stub.fake_launch, CUDA0, 0, 3)
    stub.stream = 5678
    _build.launch(stub.fake_launch, CUDA0, 0, 4)
    assert [c[-1] for c in stub.calls] == [1234, 5678] and _build.launches == {"fake": 2}


def test_plan_makes_each_key_once_keeps_nothing_that_raised_and_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(_build, "_plans", {})
    monkeypatch.setattr(_build, "plan_hits", {"fake": 0})
    monkeypatch.setattr(_build, "plan_misses", {"fake": 0})
    monkeypatch.setattr(_build, "MAX_PLANS", 2)
    made = []

    def make(value):
        made.append(value)
        if value is None:
            raise ValueError("no plan")
        return value

    assert [_build.plan(("fake", k), lambda k=k: make(k)) for k in (1, 1, 2)] == [1, 1, 2]
    for _ in range(2):
        with pytest.raises(ValueError, match="no plan"):
            _build.plan(("fake", None), lambda: make(None))
    assert _build.plan(("fake", 3), lambda: make(3)) == 3  # the third key drops the first
    assert _build.plan(("fake", 1), lambda: make(1)) == 1
    assert made == [1, 2, None, None, 3, 1] and list(_build._plans) == [("fake", 3), ("fake", 1)]
    assert (_build.plan_misses["fake"], _build.plan_hits["fake"]) == (6, 1)


def test_dryrun_reads_a_copy_of_the_one_count():
    counts = dryrun._launch_counts()
    assert list(counts) == KERNEL_KEYS and counts == _build.launches and counts is not _build.launches


CPU = torch.device("cpu")
ROWS = torch.zeros((4, 6), dtype=torch.int32)[:, :3]  # a row view: unit last stride, not contiguous


@pytest.mark.parametrize("t,dtype,shape,layout,match", [
    (torch.zeros((2, 3)), torch.int32, (2, 3), "contiguous",
     "expected torch.int32 \\(2, 3\\) on cpu, got torch.float32"),
    (torch.zeros((2, 3)), torch.float32, (3, 2), "contiguous",
     "expected torch.float32 \\(3, 2\\) on cpu, got .* \\(2, 3\\)"),
    (torch.zeros((2, 3), device="meta"), torch.float32, (2, 3), "contiguous",
     "expected torch.float32 \\(2, 3\\) on cpu, got .* on meta"),
    (ROWS, torch.int32, (4, 3), "contiguous", "expected a contiguous torch.int32 \\(4, 3\\) on cpu, got strides"),
    (ROWS.T, torch.int32, (3, 4), "rows", "expected a unit last stride torch.int32 \\(3, 4\\) on cpu, got strides"),
])
def test_check_names_what_it_expected_and_got(t, dtype, shape, layout, match):
    with pytest.raises(ValueError, match=f"^x: {match}"):
        _build.check("x", t, CPU, dtype, shape, layout)


@pytest.mark.parametrize("t,shape,layout", [(ROWS, (4, 3), "rows"), (ROWS.T, (3, 4), "any"),
                                            (torch.zeros(5, dtype=torch.int32), (5,), "contiguous")])
def test_check_takes_each_layout_it_allows(t, shape, layout):
    _build.check("x", t, CPU, torch.int32, shape, layout)


HEAP = torch.zeros((4, 5, 8), dtype=torch.int32)[:, 2]  # a tree's row view of (S, T, nodes) heaps


@pytest.mark.parametrize("t,layout,match", [
    (HEAP, "rows", None), (HEAP[:, :3], "rows", None), (HEAP.T.contiguous().T, "any", None),
    (HEAP[:, :2], "rows", "expected torch.int32 \\(4, 3\\) on cpu, got torch.int32 \\(4, 2\\)"),
    (HEAP.T.contiguous().T, "rows", "expected a unit last stride torch.int32 \\(4, 8\\) on cpu, got strides"),
    (HEAP.float(), "rows", "expected torch.int32 \\(4, 8\\) on cpu, got torch.float32"),
    (HEAP[0], "rows", "expected torch.int32 \\(4, 3\\) on cpu, got torch.int32 \\(8,\\)"),
])
def test_check_table_takes_wider_tables_and_refuses_the_rest(t, layout, match):
    if match is None:
        assert _build.check_table("x", t, CPU, torch.int32, 4, 3, layout) == t.stride()
    else:
        with pytest.raises(ValueError, match=f"^x: {match}"):
            _build.check_table("x", t, CPU, torch.int32, 4, 3, layout)


def test_device_dispatch_takes_cuda_or_cpu_only():
    assert _build.device(torch.zeros(1), "k") == CPU
    with pytest.raises(ValueError, match="k runs on CUDA or CPU tensors, got meta"):
        _build.device(torch.zeros(1, device="meta"), "k")


def _tool_variants(tool):
    if tool == "hist_profile":
        from ae_waveforms_tpu_torch.tools import hist_profile

        return "gbt_hist", hist_profile.variants((_build.CSRC / "gbt_hist.cu").read_text(), own=True)
    if tool == "route_profile":
        from ae_waveforms_tpu_torch.tools import route_profile

        return "gbt_route", route_profile.variants((_build.CSRC / "gbt_route.cu").read_text())
    from ae_waveforms_tpu_torch.tools import encoder_profile

    return "lstm_encoder", encoder_profile.variants((_build.CSRC / "lstm_encoder.cu").read_text())


@pytest.mark.parametrize("tool", ["hist_profile", "route_profile", "encoder_profile"])
def test_profile_variants_keep_the_kernels_launcher(tool):
    # each build a profile times is launched through _build.launch with the
    # package's own arguments, so its launcher's prototype must not change
    kernel, variants = _tool_variants(tool)
    launcher = f"{kernel}_launch"
    want = _build.signatures((_build.CSRC / _build.KERNELS[kernel]).read_text())[launcher]
    assert "kernel" in variants and len(variants) >= 3
    for name, text in variants.items():
        assert _build.signatures(text)[launcher] == want, name


# Each wrapper's CUDA branch on the CPU: meta tensors (no storage, address 0)
# stand in for the card's, and a stub library bound to the real prototypes
# records each launch, so the arguments a wrapper passes, its plan
# included, are checked here and not first on the card.
META = torch.device("meta")
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15}


def _values(args) -> tuple:
    """The values a C function receives for ``args``: a plan's scalars are
    ctypes objects, which ctypes passes on as their values."""
    return tuple(a.value if isinstance(a, ctypes._SimpleCData) else a for a in args)


class _Recorded(list):
    """The launches of a test, (launcher, arguments) each, on the stand-in
    card: the current stream is ``stream``; the meta tensors' device, which
    has no index, is the current one."""

    stream = 7
    current = None
    switches: list


@pytest.fixture
def recorded(monkeypatch):
    from ae_waveforms_tpu_torch.ops import gbt_hist, gbt_route, gbt_split

    calls, libs = _Recorded(), {}
    calls.switches = []

    def load(name):
        if name not in libs:
            text = (_build.CSRC / _build.KERNELS[name]).read_text()
            lib = types.SimpleNamespace()
            for fn_name in _build.signatures(text):
                setattr(lib, fn_name, lambda *args, _name=fn_name: calls.append((_name, _values(args))) or 0)
            libs[name] = _build.bind(lib, text)
        return libs[name]

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "device", lambda t, what: t.device)
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.launches, 0))
    monkeypatch.setattr(_build, "plan_hits", dict.fromkeys(_build.launches, 0))
    monkeypatch.setattr(_build, "plan_misses", dict.fromkeys(_build.launches, 0))
    monkeypatch.setattr(_build, "_plans", {})
    _stand_in_for_the_card(monkeypatch, calls)
    monkeypatch.setattr(gbt_hist, "active_clusters", lambda index: H100_ACTIVE)
    monkeypatch.setattr(gbt_route, "_sms", lambda index: 132)
    monkeypatch.setattr(gbt_split, "_max_warps", lambda: 8)  # the kernel's kMaxWarps
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _fault(t, kind: str):
    """A tensor of ``t``'s shape with another dtype ("dtype"), on the CPU
    ("device") or with a stride of 2 along its last axis ("layout")."""
    if kind == "dtype":
        return torch.zeros(t.shape, dtype=torch.float32 if t.dtype == torch.float64 else torch.float64, device=t.device)
    if kind == "device":
        return torch.zeros(t.shape, dtype=t.dtype)
    return torch.zeros((*t.shape[:-1], 2 * t.shape[-1]), dtype=t.dtype, device=t.device)[..., ::2]


def _given(tensors: dict, faults: dict) -> dict:
    """``tensors`` with each one named in ``faults`` replaced by its fault."""
    return {k: _fault(t, faults[k]) if k in faults else t for k, t in tensors.items()}


def _hist_case(S=27, n=8000, **faults):
    from ae_waveforms_tpu_torch.ops.gbt_hist import hist_plan, left_histograms_fixed

    F, B, half = 10, 64, 16
    i32 = torch.int32
    t = _given(dict(binsT=_meta(F, n, dtype=i32), g=_meta(S, n), h=_meta(S, n), node_of=_meta(S, n, dtype=i32),
                    shift=_meta(S, dtype=i32)), faults)
    left_histograms_fixed(*t.values(), half=half, n_bins=B)
    p = hist_plan(S, n, F, B, half, H100_ACTIVE)
    return "gbt_hist_launch", (S, n, 16, 1, F, B, half, p.cluster, p.node_tile, p.feature_tile, p.threads, p.smem_bytes)


def _route_rows_case(S=27, n=8000, **faults):
    from ae_waveforms_tpu_torch.ops.gbt_route import route_plan, route_rows

    F, nodes = 10, 32
    i32 = torch.int32
    heap = [_meta(S, 127, dtype=i32), _meta(S, 127, dtype=i32), _meta(S, 127, dtype=torch.bool)]
    t = _given(dict(binsT=_meta(F, n, dtype=i32), node_of=_meta(S, n, dtype=i32),
                    **{k: x[:, nodes - 1:2 * nodes - 1] for k, x in zip(("bf", "bb", "do_split"), heap)}), faults)
    route_rows(*t.values())
    p = route_plan(S, n, F, 1, nodes, 132)
    return "gbt_route_launch", (S, n, F, nodes, 1, p.chunk, p.tile, p.vec, int(p.staged), p.blocks, p.threads,
                                p.smem_bytes)


def _route_levels_case():
    from ae_waveforms_tpu_torch.ops.gbt_route import route_levels, route_plan

    S, n, F, depth = 100, 64, 10, 6
    i32 = torch.int32
    route_levels(_meta(n, F, dtype=i32).T, None, _meta(S, 2**depth, dtype=i32), _meta(S, 2**depth, dtype=i32),
                 _meta(S, 2**depth, dtype=torch.bool), 0, depth)
    p = route_plan(S, n, F, depth, 1, 132)  # the heaps are wider than the levels' 63 splits: width 1 all the same
    return "gbt_route_launch", (S, n, F, 1, depth, p.chunk, p.tile, p.vec, int(p.staged), p.blocks, p.threads,
                                p.smem_bytes)


def _split_case(S=27, depth=5, **faults):
    from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA, _warps, split_level

    F, B = 10, 64
    half = 2**depth // 2
    i32, i64 = torch.int32, torch.int64
    heap = (_meta(S, 127, dtype=i32), _meta(S, 127, dtype=i32), _meta(S, 127, dtype=torch.bool))
    t = _given(dict(q=_meta(S, 2 * half, F * B, dtype=i64), parent=_meta(S, 2 * half, F * B, dtype=i64),
                    shift=_meta(S, dtype=i32), gammas=_meta(S), min_child_weights=_meta(S),
                    col=_meta(S, F, dtype=torch.bool), depth_limits=_meta(S, dtype=i64)), faults)
    split_level(*t.values(), heap, depth=depth, n_bins=B, last=False)
    return "gbt_split_launch", (127, 127, 127, 0, 0, S, 2**depth, F, B, depth, LAMBDA, _warps(F, 8))


def _grad_case(S=27, n=8000, **faults):
    from ae_waveforms_tpu_torch.ops.gbt_tree import tree_grad

    F, tree = 10, 3
    t = _given(dict(margin=_meta(S, n), y=_meta(n), row_weights=_meta(S, n), seeds=_meta(S, dtype=torch.int64),
                    subsamples=_meta(S), colsamples=_meta(S)), faults)
    tree_grad(*t.values(), tree=tree, n_features=F)
    return "gbt_grad_launch", (S, n, F, tree, 62 - (n - 1).bit_length())


def _leaves_case(S=27, n=8000, **faults):
    from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA
    from ae_waveforms_tpu_torch.ops.gbt_tree import tree_leaves

    T, L, tree = 500, 64, 3
    t = _given(dict(leaf_sums=_meta(S, L // 2, 4, dtype=torch.int64), shift=_meta(S, dtype=torch.int32),
                    learning_rates=_meta(S), n_actives=_meta(S, dtype=torch.int64),
                    node_of=_meta(S, n, dtype=torch.int32), margin=_meta(S, n), leaf=_meta(S, T, L)), faults)
    tree_leaves(*t.values(), tree=tree)
    return "gbt_leaves_launch", (T * L, S, n, L, tree, LAMBDA)


def _encoder_case():
    from ae_waveforms_tpu_torch.ops.lstm_encoder import encode_fused, encoder_plan

    B, T, widths = 128, 320, (1, 128, 64, 10)
    params = {f"enc{i}": {"w_ih": _meta(4 * h, k), "w_hh": _meta(4 * h, h), "b_ih": _meta(4 * h), "b_hh": _meta(4 * h)}
              for i, (k, h) in enumerate(zip(widths, widths[1:]), 1)}
    with torch.no_grad():
        encode_fused(params, _meta(B, T, 1))
    return "lstm_encoder_launch", (0,) * 14 + (B, T, 128, 64, 10, *encoder_plan(B, 128, 64, 10, T))


@pytest.mark.parametrize("case", [_hist_case, _route_rows_case, _route_levels_case, _split_case, _grad_case,
                                  _leaves_case, _encoder_case], ids=lambda f: f.__name__.strip("_"))
def test_wrapper_launches_with_its_plan(recorded, case):
    launcher, tail = case()
    assert [name for name, _ in recorded] == [launcher]
    args = recorded[0][1]
    assert len(args) == ARITY[launcher] and args[-1] == 7  # the stream last
    assert args[-1 - len(tail):-1] == tail
    assert _build.launches[launcher[: -len("_launch")]] == 1


# The plan cache (``_build.plan``): what a launch needs besides its tensors
# is made once a key, and every call still checks every tensor.
GBT_CASES = [_hist_case, _route_rows_case, _split_case, _grad_case, _leaves_case]
OTHER_SHAPE = {_hist_case: dict(S=21, n=12000), _route_rows_case: dict(S=21, n=12000), _split_case: dict(S=21, depth=3),
               _grad_case: dict(S=21, n=12000), _leaves_case: dict(S=21, n=12000)}


@pytest.mark.parametrize("case", GBT_CASES, ids=lambda f: f.__name__.strip("_"))
def test_plan_cache_launches_each_shape_with_its_own_plan(recorded, case):
    launched = [case()]
    kernel = launched[0][0][: -len("_launch")]
    assert (_build.plan_misses[kernel], _build.plan_hits[kernel]) == (1, 0)
    recorded.stream = 9  # another stream made current between two calls
    launched.append(case())
    assert (_build.plan_misses[kernel], _build.plan_hits[kernel]) == (1, 1)
    launched.append(case(**OTHER_SHAPE[case]))
    assert (_build.plan_misses[kernel], _build.plan_hits[kernel]) == (2, 1)
    launched.append(case())
    assert (_build.plan_misses[kernel], _build.plan_hits[kernel]) == (2, 2)
    assert launched[0][1] != launched[2][1]  # the two shapes' plans differ
    assert len(recorded) == 4 and _build.launches[kernel] == 4
    for (name, args), (launcher, tail), stream in zip(recorded, launched, (7, 9, 9, 9)):
        assert name == launcher and args[-1 - len(tail):-1] == tail and args[-1] == stream
    assert recorded.switches == []


FAULTS = [(_hist_case, "g", "dtype", "g"), (_hist_case, "h", "device", "h"),
          (_hist_case, "node_of", "layout", "node_of"), (_route_rows_case, "node_of", "dtype", "node_of"),
          (_route_rows_case, "binsT", "device", "bins"), (_route_rows_case, "bf", "layout", "feat"),
          (_split_case, "gammas", "dtype", "gammas"), (_split_case, "col", "device", "col"),
          (_split_case, "parent", "layout", "parent"), (_grad_case, "y", "dtype", "y"),
          (_grad_case, "seeds", "device", "seeds"), (_grad_case, "row_weights", "layout", "row_weights"),
          (_leaves_case, "shift", "dtype", "shift"), (_leaves_case, "n_actives", "device", "n_actives"),
          (_leaves_case, "leaf", "layout", "leaf")]


@pytest.mark.parametrize("case,name,kind,checked", FAULTS,
                         ids=[f"{f.__name__.strip('_')}-{name}-{kind}" for f, name, kind, _ in FAULTS])
def test_plan_cache_hit_still_checks_every_tensor(recorded, case, name, kind, checked):
    launcher = case()[0]
    case()
    kernel = launcher[: -len("_launch")]
    assert (_build.plan_misses[kernel], _build.plan_hits[kernel]) == (1, 1)
    with pytest.raises(ValueError, match=f"^{checked}: expected"):
        case(**{name: kind})
    assert len(recorded) == 2 and _build.launches[kernel] == 2
