"""The port's one kernel launch contract (``ops/_build.py``), on the CPU:
the ctypes signatures read from the ``extern "C"`` prototypes of
``csrc/*.cu`` against the hand-written lists they replaced, the launch path
on a stub library, the one tensor check and the one launch count.  Nothing
is compiled."""

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
    assert list(_build.launches) == KERNEL_KEYS
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


@pytest.fixture
def stub(monkeypatch):
    """A library whose ``fake_launch(const float*, int, cudaStream_t)``
    records its calls and returns ``stub.rc``; the current device and stream
    are stood in for, and the count is a fresh one."""
    lib = types.SimpleNamespace(calls=[], rc=0)

    def fake_launch(*args):
        lib.calls.append(args)
        return lib.rc

    lib.fake_launch = fake_launch
    _build.bind(lib, 'extern "C" int fake_launch(const float* x, int n, cudaStream_t stream) { return 0; }')
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(_build, "launches", {"fake": 0})
    return lib


def test_launch_appends_the_stream_and_counts(stub):
    _build.launch(stub.fake_launch, torch.device("cpu"), 0, 3)
    assert stub.calls == [(0, 3, 1234)] and _build.launches == {"fake": 1}


@pytest.mark.parametrize("args", [(0,), (0, 3, 5)])
def test_launch_refuses_a_wrong_argument_count_before_the_call(stub, args):
    with pytest.raises(TypeError, match="fake_launch takes 2 arguments"):
        _build.launch(stub.fake_launch, torch.device("cpu"), *args)
    assert stub.calls == [] and _build.launches == {"fake": 0}


def test_launch_raises_naming_the_kernel_and_the_error(stub):
    stub.rc = 700
    with pytest.raises(RuntimeError, match="fake kernel launch failed: cudaError_t 700"):
        _build.launch(stub.fake_launch, torch.device("cpu"), 0, 3)
    assert len(stub.calls) == 1 and _build.launches == {"fake": 0}


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


@pytest.fixture
def recorded(monkeypatch):
    from ae_waveforms_tpu_torch.ops import gbt_hist, gbt_route, gbt_split

    calls, libs = [], {}

    def load(name):
        if name not in libs:
            text = (_build.CSRC / _build.KERNELS[name]).read_text()
            lib = types.SimpleNamespace()
            for fn_name in _build.signatures(text):
                setattr(lib, fn_name, lambda *args, _name=fn_name: calls.append((_name, args)) or 0)
            libs[name] = _build.bind(lib, text)
        return libs[name]

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "device", lambda t, what: t.device)
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.launches, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(gbt_hist, "active_clusters", lambda index: H100_ACTIVE)
    monkeypatch.setattr(gbt_route, "_sms", lambda index: 132)
    monkeypatch.setattr(gbt_split, "_max_warps", lambda: 8)  # the kernel's kMaxWarps
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _hist_case():
    from ae_waveforms_tpu_torch.ops.gbt_hist import hist_plan, left_histograms_fixed

    S, n, F, B, half = 27, 8000, 10, 64, 16
    i32 = torch.int32
    left_histograms_fixed(_meta(F, n, dtype=i32), _meta(S, n), _meta(S, n), _meta(S, n, dtype=i32), _meta(S, dtype=i32),
                          half=half, n_bins=B)
    p = hist_plan(S, n, F, B, half, H100_ACTIVE)
    return "gbt_hist_launch", (S, n, 16, 1, F, B, half, p.cluster, p.node_tile, p.feature_tile, p.threads, p.smem_bytes)


def _route_rows_case():
    from ae_waveforms_tpu_torch.ops.gbt_route import route_plan, route_rows

    S, n, F, nodes = 27, 8000, 10, 32
    i32 = torch.int32
    heap = [_meta(S, 127, dtype=i32), _meta(S, 127, dtype=i32), _meta(S, 127, dtype=torch.bool)]
    route_rows(_meta(F, n, dtype=i32), _meta(S, n, dtype=i32), *(x[:, nodes - 1:2 * nodes - 1] for x in heap))
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


def _split_case():
    from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA, _warps, split_level

    S, F, B, depth = 27, 10, 64, 5
    half = 2**depth // 2
    i32, i64 = torch.int32, torch.int64
    heap = (_meta(S, 127, dtype=i32), _meta(S, 127, dtype=i32), _meta(S, 127, dtype=torch.bool))
    split_level(_meta(S, 2 * half, F * B, dtype=i64), _meta(S, 2 * half, F * B, dtype=i64), _meta(S, dtype=i32),
                _meta(S), _meta(S), _meta(S, F, dtype=torch.bool), _meta(S, dtype=i64), heap, depth=depth, n_bins=B,
                last=False)
    return "gbt_split_launch", (127, 127, 127, 0, 0, S, 2**depth, F, B, depth, LAMBDA, _warps(F, 8))


def _grad_case():
    from ae_waveforms_tpu_torch.ops.gbt_tree import tree_grad

    S, n, F, tree = 27, 8000, 10, 3
    tree_grad(_meta(S, n), _meta(n), _meta(S, n), _meta(S, dtype=torch.int64), _meta(S), _meta(S), tree=tree,
              n_features=F)
    return "gbt_grad_launch", (S, n, F, tree, 62 - (n - 1).bit_length())


def _leaves_case():
    from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA
    from ae_waveforms_tpu_torch.ops.gbt_tree import tree_leaves

    S, n, T, L, tree = 27, 8000, 500, 64, 3
    tree_leaves(_meta(S, L // 2, 4, dtype=torch.int64), _meta(S, dtype=torch.int32), _meta(S),
                _meta(S, dtype=torch.int64), _meta(S, n, dtype=torch.int32), _meta(S, n), _meta(S, T, L), tree=tree)
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
