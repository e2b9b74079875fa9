"""The host side of the MSDA backward (datr_torch/ops/msda.py:msda_bwd and
its arguments to the C entry point), on the CPU. The launch itself is
planned in C from the sizes, the pointers' alignment and the card's SM count
(csrc/msda_common.cuh:msda_plan; csrc/msda_bwd.cu:bwd_bf16 for bf16, which
asks for no shared memory) and runs only on the card
(tests/test_torch_port_gpu.py). Here every shape the repo runs goes through
the wrapper on the meta device, at its full size, against a recording
stand-in for the kernel library: what it allocates (the outputs and, in
bf16, an f32 workspace of value's shape that the C call zeroes, so nothing
is zero-filled here) and what it passes. Then the three routes (f32, bf16,
f64) on small CPU tensors, every D and misaligned views."""

import ctypes
from types import SimpleNamespace

import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.ops import msda

SHAPES = ((4, 6), (2, 3))
C2F = ((152, 256), (76, 128), (38, 64), (19, 32))  # 1216x2048, S 51,680
SERVE = ((100, 168), (50, 84), (25, 42), (13, 21))  # 800x1344, S 22,323
FIVE = ((200, 336),) + SERVE  # DINO_5scale on 800x1344, S 89,523
C2F_S = sum(h * w for h, w in C2F)
SERVE_S = sum(h * w for h, w in SERVE)
FIVE_S = sum(h * w for h, w in FIVE)

# name: (B, level shapes, Lq, H, P) of a backward launch on a path of the
# repo, D = 32
PATHS = {
    "c2f encoder": (2, C2F, C2F_S, 8, 4),
    "c2f decoder source (900 + 200 DN)": (2, C2F, 1100, 8, 4),
    "c2f decoder target": (2, C2F, 900, 8, 4),
    # train_bench / profile_model / the f64 and masks steps at 800x1344,
    # one image a domain
    "800x1344 encoder, batch 1": (1, SERVE, SERVE_S, 8, 4),
    "800x1344 decoder, batch 1": (1, SERVE, 1100, 8, 4),
    "800x1344 encoder, batch 2 (masks, backbones)": (2, SERVE, SERVE_S, 8,
                                                     4),
    "800x1344 decoder, batch 2": (2, SERVE, 900, 8, 4),
    "DINO_5scale encoder": (2, FIVE, FIVE_S, 8, 4),
    "DINO_5scale decoder": (2, FIVE, 900, 8, 4),
    "DINO_4scale_fast encoder": (2, SERVE, SERVE_S, 8, 2),
    "tp rank (4 heads) encoder": (2, C2F, C2F_S, 4, 4),
    "tp rank (4 heads) decoder": (2, C2F, 1100, 4, 4),
    "sp rank (half the queries)": (2, C2F, -(-C2F_S // 2), 8, 4),
    "sp rank, 800x1344": (2, SERVE, -(-SERVE_S // 2), 8, 4),
}


class _Lib:
    """A recording stand-in for the kernel library: each entry point
    returns success and keeps its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("msda_bwd"):
            return lambda *args: self.calls.append((name, args)) or 0
        raise AttributeError(name)


def _cpu_route(monkeypatch, lib):
    """The wrapper's CUDA route with its device check and CUDA calls
    pointed at the CPU, so that its host side runs here."""
    monkeypatch.setattr(msda._build, "load_library", lambda: lib)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(msda, "_check_msda_inputs", lambda name, value, sh,
                        loc, attn, *more: _shapes_of(value, sh, loc))


def _shapes_of(value, sh, loc):
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    return B, S, Lq, H, D, L, P


def _record_allocations(monkeypatch):
    """torch.empty's calls as (shape, dtype); torch.zeros / zeros_like
    raise for bf16 value (the C call zeroes its own workspace)."""
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    def no_zeros(*a, **kw):
        raise AssertionError("the bf16 route zero-fills on the host")

    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch, "zeros", no_zeros)
    monkeypatch.setattr(torch, "zeros_like", no_zeros)
    return made


@pytest.mark.parametrize("name", list(PATHS))
def test_plan_of_every_path(monkeypatch, name):
    """bf16 at the path's full size: one call of `msda_bwd` (dtype 1) with
    the sizes and the level shapes, an f32 workspace of value's shape from
    torch.empty (23-183 MB here, zeroed by the C call) besides the
    outputs, no zero-fill on the host, one launch counted."""
    B, shapes, Lq, H, P = PATHS[name]
    S, L, D = sum(h * w for h, w in shapes), len(shapes), 32
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    meta = dict(device="meta")
    value = torch.empty(B, S, H, D, dtype=torch.bfloat16, **meta)
    loc = torch.empty(B, Lq, H, L, P, 2, **meta)
    attn = torch.empty(B, Lq, H, L, P, **meta)
    g = torch.empty(B, Lq, H * D, dtype=torch.bfloat16, **meta)
    made = _record_allocations(monkeypatch)
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, shapes, loc, attn, g)
    assert msda.msda_bwd.launches == before + 1
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    assert [t.shape for t in got] == [value.shape, loc.shape, attn.shape]
    assert made == [((B, S, H, D), torch.float32)]
    ((entry, args),) = lib.calls
    assert entry == "msda_bwd"
    assert args[8:15] == (B, S, Lq, H, D, L, P)
    assert list(args[15][:2 * L]) == [v for hw in shapes for v in hw]
    assert args[16] == msda.DTYPE_CODE[torch.bfloat16] == 1


def _inputs(dtype, lq=5, h=2, d=32, offset=0):
    """Small CPU inputs; `offset` elements cut from the front of value's
    and grad_out's storage make misaligned contiguous views."""
    g = torch.Generator().manual_seed(0)
    s_tok, n_l = sum(a * b for a, b in SHAPES), len(SHAPES)
    cd = msda.compute_dtype(torch.empty(0, dtype=dtype))
    value = torch.randn(2 * s_tok * h * d + offset, generator=g).to(dtype)
    value = value[offset:].view(2, s_tok, h, d)
    loc = torch.rand(2, lq, h, n_l, 2, 2, generator=g, dtype=cd)
    attn = torch.rand(2, lq, h, n_l, 2, generator=g, dtype=cd)
    grad = torch.randn(2 * lq * h * d + offset, generator=g).to(dtype)
    return value, loc, attn, grad[offset:].view(2, lq, h * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_wrapper_arguments(monkeypatch, dtype):
    """f32 and f64 pass grad_value (zeros, value's type) as the workspace;
    bf16 an f32 workspace of value's shape (zeroed by the entry point, not
    here) and a bf16 grad_value. One entry point, value's dtype code, one
    launch counted per call either way."""
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    value, loc, attn, g = _inputs(dtype)
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    assert msda.msda_bwd.launches == before + 1
    assert [t.dtype for t in got] == [dtype, loc.dtype, loc.dtype]
    assert [t.shape for t in got] == [value.shape, loc.shape, attn.shape]
    ((name, args),) = lib.calls
    assert name == "msda_bwd"
    B, S, H, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    assert args[:4] == (value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        g.data_ptr())
    assert args[5:8] == tuple(t.data_ptr() for t in got)
    assert args[8:15] == (B, S, Lq, H, D, L, P)
    assert list(args[15][:2 * L]) == [v for hw in SHAPES for v in hw]
    assert args[16] == msda.DTYPE_CODE[dtype]
    if dtype == torch.bfloat16:
        assert args[4] != args[5]  # the f32 sum, then the bf16 result
        assert args[4] % 16 == 0  # the C call's 16-byte reductions
    else:
        assert args[4] == args[5]
        assert torch.count_nonzero(got[0]) == 0  # the zeroed sum


@pytest.mark.parametrize("d,offset", [
    (32, 0), (64, 0), (16, 0), (8, 0), (256, 0), (512, 0), (48, 0),
    (5, 0), (6, 0),
    (32, 1), (32, 2),  # misaligned views: 2- and 4-byte aligned rows
])
def test_wrapper_takes_every_width(monkeypatch, d, offset):
    """bf16 value of any D, and contiguous views at any offset, go to the
    C call as they are (its vector width follows D and the pointers): no
    copy, the workspace and grad_value value's shape."""
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    value, loc, attn, g = _inputs(torch.bfloat16, d=d, offset=offset)
    assert value.data_ptr() % 16 == (2 * offset) % 16
    made = _record_allocations(monkeypatch)
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    ((_, args),) = lib.calls
    assert (args[0], args[3]) == (value.data_ptr(), g.data_ptr())
    assert args[12] == d
    assert made == [(tuple(value.shape), torch.float32)]
    assert got[0].shape == value.shape


@pytest.mark.parametrize("lq", [0, 1, 31, 32, 33, 8461])
def test_wrapper_at_every_query_count(monkeypatch, lq):
    """Any query count, Lq = 0 included, is one call of the entry point
    (with no queries it still zeroes and rounds the workspace, so that
    grad_value comes back zero) and one launch counted."""
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    value, loc, attn, g = _inputs(torch.bfloat16, lq=lq, h=8)
    before = msda.msda_bwd.launches
    got = msda.msda_bwd(value, SHAPES, loc, attn, g)
    assert msda.msda_bwd.launches == before + 1
    ((_, args),) = lib.calls
    assert args[10] == lq
    assert got[1].shape == loc.shape and got[2].shape == attn.shape


def test_c_signature_matches_the_wrapper():
    """The ctypes declaration of msda_bwd takes what the wrapper passes: 8
    pointers, 7 sizes, the level shapes, the dtype code, the device and
    the stream; the library has no other backward entry point."""
    argtypes, restype = msda._build._SIGNATURES["msda_bwd"]
    P, I = ctypes.c_void_p, ctypes.c_int
    assert argtypes == [P] * 8 + [I] * 7 + [ctypes.POINTER(I)] + [I] * 2 + [P]
    assert restype is I
    assert [n for n in msda._build._SIGNATURES
            if n.startswith("msda_bwd")] == ["msda_bwd"]


def test_route_counts_read_from_the_library(monkeypatch):
    """msda_bwd_routes reads one count per route from the library's
    `datr_msda_bwd_routes`, declared to take one pointer, in the order of
    BWD_ROUTES (csrc/msda_bwd.cu's MsdaBwdRoute)."""
    assert msda._build._SIGNATURES["datr_msda_bwd_routes"] == (
        [ctypes.c_void_p], None)

    def fill(out):
        for r in range(len(msda.BWD_ROUTES)):
            out[r] = 10 * r + 1

    monkeypatch.setattr(msda._build, "load_library",
                        lambda: SimpleNamespace(datr_msda_bwd_routes=fill))
    assert msda.msda_bwd_routes() == {
        r: 10 * i + 1 for i, r in enumerate(msda.BWD_ROUTES)}
    src = (msda._build.CSRC_DIR / "msda_bwd.cu").read_text()
    enum = src[src.index("enum MsdaBwdRoute"):].split("};")[0]
    assert enum.count("= ") == len(msda.BWD_ROUTES) + 1  # and the count
