"""The host side of the MSDA forward (datr_torch/ops/msda.py:msda_fwd and
its arguments to the C entry point) on the CPU, and the rule by which
chip_smoke.py holds the C launcher's choice of kernel (`fwd_route`): bf16
or f64 value at D = 32 on a 16-byte boundary in a long launch takes the
run kernel of its type, every other launch msda_fwd_kernel. The kernels
themselves run only on the card (tests/test_torch_port_gpu.py, which also
checks each launch's kernel by the launcher's counts). Here every shape the
repo runs goes through the wrapper on the meta device, at its full size,
against a recording stand-in for the kernel library."""

import ctypes
from types import SimpleNamespace

import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

import chip_smoke
from datr_torch.ops import msda
from test_torch_port_msda_bwd_plan import PATHS, SHAPES

RUN = "msda_fwd_bf16_run_kernel"
F64_RUN = "msda_fwd_run_kernel f64"
H100_SMS = 132


class _Lib:
    """A recording stand-in for the kernel library's msda_fwd."""

    def __init__(self):
        self.calls = []

    def msda_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def h100(monkeypatch):
    """The card's SM count as fwd_route reads it, for any device."""
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device=None: SimpleNamespace(multi_processor_count=H100_SMS))


def _cpu_route(monkeypatch, lib):
    """The wrapper's CUDA route with its device check and CUDA calls
    pointed at the CPU, so that its host side runs here."""
    monkeypatch.setattr(msda._build, "load_library", lambda: lib)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: SimpleNamespace(cuda_stream=0))

    def shapes_of(name, value, sh, loc, attn, *more):
        B, S, H, D = value.shape
        _, Lq, _, L, P, _ = loc.shape
        return B, S, Lq, H, D, L, P

    monkeypatch.setattr(msda, "_check_msda_inputs", shapes_of)


def _plan_of(monkeypatch, name, dtype):
    """One call of `msda_fwd` in `dtype` at the path's full size on the meta
    device: its arguments to the C entry point, the one tensor allocated
    (the output [B, Lq, H * D] of value's dtype) and the launch counted;
    returns (value, loc) and the call's dtype code."""
    B, shapes, Lq, H, P = PATHS[name]
    S, L, D = sum(h * w for h, w in shapes), len(shapes), 32
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    meta = dict(device="meta")
    coords = torch.float64 if dtype == torch.float64 else torch.float32
    value = torch.empty(B, S, H, D, dtype=dtype, **meta)
    loc = torch.empty(B, Lq, H, L, P, 2, dtype=coords, **meta)
    attn = torch.empty(B, Lq, H, L, P, dtype=coords, **meta)
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    before = msda.msda_fwd.launches
    out = msda.msda_fwd(value, shapes, loc, attn)
    assert msda.msda_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, Lq, H * D)
    assert made == [((B, Lq, H * D), dtype)]
    (args,) = lib.calls
    assert args[4:11] == (B, S, Lq, H, D, L, P)
    assert list(args[11][:2 * L]) == [v for hw in shapes for v in hw]
    return value, loc, args[12]


@pytest.mark.parametrize("name", list(PATHS))
def test_plan_of_every_path(monkeypatch, h100, name):
    """bf16 at the path's full size: one call of `msda_fwd` (dtype 1) with
    the sizes and the level shapes, the bf16 output [B, Lq, H * D] the one
    tensor allocated, one launch counted; the encoder's launches (every
    token a query, or a sequence-parallel rank's half) take the run
    kernel, the decoder's msda_fwd_kernel."""
    value, loc, code = _plan_of(monkeypatch, name, torch.bfloat16)
    assert code == msda.DTYPE_CODE[torch.bfloat16] == 1
    encoder = "encoder" in name or "sp rank" in name
    assert chip_smoke.fwd_route(value, loc) == (
        RUN if encoder else "msda_fwd_kernel bf16")


@pytest.mark.parametrize("name", list(PATHS))
def test_f64_plan_of_every_path(monkeypatch, h100, name):
    """The same in f64 (the float64 mode; loc and attn f64): dtype 2, the
    f64 output the one tensor allocated; the encoder's launches take the
    f64 run kernel, the decoder's msda_fwd_kernel."""
    value, loc, code = _plan_of(monkeypatch, name, torch.float64)
    assert code == msda.DTYPE_CODE[torch.float64] == 2
    encoder = "encoder" in name or "sp rank" in name
    assert chip_smoke.fwd_route(value, loc) == (
        F64_RUN if encoder else "msda_fwd_kernel f64")


def _value(dtype, d=32, offset=0, s_tok=20_400, h=8):
    """A CPU value [2, s_tok, h, d]; `offset` elements cut from the front
    of its storage make a misaligned contiguous view."""
    flat = torch.zeros(2 * s_tok * h * d + offset, dtype=dtype)
    return flat[offset:].view(2, s_tok, h, d)


@pytest.mark.parametrize("dtype,d,lq,offset,route", [
    (torch.bfloat16, 32, 20_400, 0, RUN),
    (torch.bfloat16, 32, 4_224, 0, RUN),  # 2 x 4,224 x 8 / 16 = 2 x 132 x 16
    (torch.bfloat16, 32, 4_223, 0, "msda_fwd_kernel bf16"),  # one short
    (torch.bfloat16, 32, 1_100, 0, "msda_fwd_kernel bf16"),  # a decoder
    (torch.bfloat16, 32, 20_400, 1, "msda_fwd_kernel bf16"),  # off 16 bytes
    (torch.bfloat16, 64, 20_400, 0, "msda_fwd_kernel bf16"),  # D != 32
    (torch.bfloat16, 16, 20_400, 0, "msda_fwd_kernel bf16"),
    (torch.float32, 32, 20_400, 0, "msda_fwd_kernel f32"),
    (torch.float64, 32, 20_400, 0, F64_RUN),
    (torch.float64, 32, 4_224, 0, F64_RUN),  # the bf16 threshold
    (torch.float64, 32, 4_223, 0, "msda_fwd_kernel f64"),  # one short
    (torch.float64, 32, 1_100, 0, "msda_fwd_kernel f64"),  # a decoder
    (torch.float64, 32, 20_400, 2, F64_RUN),  # 16 bytes off: aligned
    (torch.float64, 32, 20_400, 1, "msda_fwd_kernel f64"),  # off 8 bytes
    (torch.float64, 64, 20_400, 0, "msda_fwd_kernel f64"),  # D != 32
    (torch.float64, 16, 20_400, 0, "msda_fwd_kernel f64"),
])
def test_fwd_route_by_geometry(h100, dtype, d, lq, offset, route):
    """The kernel each geometry takes, by the rule the smoke holds the
    launcher to (the card's own tests check the launcher against it)."""
    value = _value(dtype, d, offset)
    loc = torch.zeros(2, lq, 8, 4, 4, 2)
    assert chip_smoke.fwd_route(value, loc) == route


def test_fwd_route_needs_points(h100):
    """P = 0 leaves the run kernel out (nothing to set up)."""
    loc = torch.zeros(2, 20_400, 8, 4, 0, 2)
    assert chip_smoke.fwd_route(_value(torch.bfloat16), loc) == (
        "msda_fwd_kernel bf16")


def test_c_signature_matches_the_wrapper():
    """The ctypes declaration of msda_fwd takes what the wrapper passes: 4
    pointers, 7 sizes, the level shapes, the dtype code, the device and
    the stream."""
    argtypes, restype = msda._build._SIGNATURES["msda_fwd"]
    P, I = ctypes.c_void_p, ctypes.c_int
    assert argtypes == [P] * 4 + [I] * 7 + [ctypes.POINTER(I)] + [I] * 2 + [P]
    assert restype is I


def test_route_counts_read_from_the_library(monkeypatch):
    """msda_fwd_routes reads one count per route from the library's
    `datr_msda_fwd_routes`, declared to take one pointer, in the order of
    FWD_ROUTES (csrc/msda_fwd.cu's MsdaFwdRoute)."""
    assert msda._build._SIGNATURES["datr_msda_fwd_routes"] == (
        [ctypes.c_void_p], None)

    def fill(out):
        for r in range(len(msda.FWD_ROUTES)):
            out[r] = 10 * r + 1

    monkeypatch.setattr(msda._build, "load_library",
                        lambda: SimpleNamespace(datr_msda_fwd_routes=fill))
    assert msda.msda_fwd_routes() == {
        r: 10 * i + 1 for i, r in enumerate(msda.FWD_ROUTES)}
    src = (msda._build.CSRC_DIR / "msda_fwd.cu").read_text()
    enum = src[src.index("enum MsdaFwdRoute"):].split("};")[0]
    assert enum.count("= ") == len(msda.FWD_ROUTES) + 1  # and the count
    assert {chip_smoke.BF16_RUN, chip_smoke.F64_RUN} <= set(msda.FWD_ROUTES)


def test_wrapper_passes_small_cpu_inputs_through(monkeypatch):
    """Small CPU tensors on the wrapper's CUDA route: the pointers as they
    are (no copy), value's dtype code, an output of value's dtype."""
    lib = _Lib()
    _cpu_route(monkeypatch, lib)
    s_tok = sum(a * b for a, b in SHAPES)
    value = torch.randn(2, s_tok, 2, 32).to(torch.bfloat16)
    loc = torch.rand(2, 5, 2, len(SHAPES), 2, 2)
    attn = torch.rand(2, 5, 2, len(SHAPES), 2)
    out = msda.msda_fwd(value, SHAPES, loc, attn)
    (args,) = lib.calls
    assert args[:4] == (value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        out.data_ptr())
    assert out.shape == (2, 5, 64) and out.dtype == torch.bfloat16
