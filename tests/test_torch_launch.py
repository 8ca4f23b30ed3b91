"""The port's launch path (madeleine_torch/ops/_build.py) on the CPU, driven
through ctypes stand-ins for the C entry points with the stream lookup
monkeypatched: every kernel of the port launches through it, so what a C
function receives here is what a kernel receives on the card. Also row 21's
memoised per-site arguments and its plain masks, bit for bit against the
masks the port gave before its launch path changed."""

import ctypes
import hashlib

import pytest
import torch

from madeleine_torch.ops import _build, prng
from madeleine_torch.ops import dropout as dp

STREAM = 0x5EED   # the raw stream pointer the patched lookup hands out

_PTRS_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p)
_TYPED_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                ctypes.c_void_p)


class _Lib:
    """Stands for a loaded library: its attributes are the entry points."""

    def __init__(self, **fns):
        self.__dict__.update(fns)


@pytest.fixture()
def stand_in(monkeypatch):
    """A library "fake" with a call_ptrs-style entry `ptrs_fn` and a typed
    entry `typed_fn`, each recording what it received and returning
    `ret["err"]`; the stream lookup and the current device patched."""
    seen, ret, loads = {}, {"err": 0}, []

    def ptrs_fn(p, dims, scales, stream):
        seen["p"] = [ctypes.cast(p, ctypes.POINTER(ctypes.c_void_p))[i] for i in range(3)]
        seen["dims"] = ctypes.cast(dims, ctypes.POINTER(ctypes.c_longlong))[:4]
        seen["scales"] = ctypes.cast(scales, ctypes.POINTER(ctypes.c_float))[:2]
        seen["stream"] = stream
        return ret["err"]

    def typed_fn(ptr, n, scale, stream):
        seen["typed"] = (ptr, n, scale, stream)
        return ret["err"]

    lib = _Lib(ptrs_fn=_PTRS_PROTO(ptrs_fn), typed_fn=_TYPED_PROTO(typed_fn))

    def load(name):
        loads.append(name)
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "current_stream", lambda index: STREAM + index)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    return seen, ret, loads


def test_call_ptrs_passes_pointers_dims_scales_and_the_stream(stand_in):
    seen, _, loads = stand_in
    a, b = torch.zeros(8), torch.zeros(3, dtype=torch.float64)
    for _ in range(2):
        _build.call_ptrs("fake", "ptrs_fn", [a, None, b], [7, -2, 2 ** 40, 0], [0.5, 1.25],
                         torch.device("cuda"))
    assert seen["p"] == [a.data_ptr(), None, b.data_ptr()]
    assert seen["dims"] == [7, -2, 2 ** 40, 0]
    assert seen["scales"] == [0.5, 1.25]
    assert seen["stream"] == STREAM   # device 0, the current one
    assert loads == ["fake"]          # resolved once, then the prepared function


def test_launch_passes_typed_arguments(stand_in):
    seen, _, _ = stand_in
    x = torch.zeros(4)
    _build.launch("fake", "typed_fn", [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p], [x, 9, 0.75], torch.device("cuda", 0))
    assert seen["typed"] == (x.data_ptr(), 9, 0.75, STREAM)


def test_another_device_is_entered_for_the_call_only(stand_in, monkeypatch):
    """A tensor on device 1 while device 0 is current: the call runs inside
    device 1's context on device 1's stream; on the current device no
    context is entered."""
    seen, _, _ = stand_in
    entered = []

    class _Ctx:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _Ctx)
    x = torch.zeros(2)
    _build.call_ptrs("fake", "ptrs_fn", [x, x, x], [1, 2, 3, 4], [1.0], torch.device("cuda", 1))
    assert entered == [1] and seen["stream"] == STREAM + 1
    _build.call_ptrs("fake", "ptrs_fn", [x, x, x], [1, 2, 3, 4], [], torch.device("cuda", 0))
    assert entered == [1] and seen["stream"] == STREAM
    assert seen["scales"][0] == 0.0   # no scales: a one-float array of 0


def test_a_nonzero_cuda_error_raises_naming_the_library(stand_in):
    _, ret, _ = stand_in
    ret["err"] = 98
    x = torch.zeros(2)
    with pytest.raises(RuntimeError, match="fake kernel launch failed: cudaError 98"):
        _build.call_ptrs("fake", "ptrs_fn", [x, x, x], [1, 2, 3, 4], [1.0], torch.device("cuda"))
    with pytest.raises(RuntimeError, match="fake kernel launch failed: cudaError 98"):
        _build.launch("fake", "typed_fn", [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p], [x, 1, 1.0], torch.device("cuda"))


def test_check_operand_raises_on_each_mismatch():
    x = torch.zeros(4, 6)
    dev = x.device
    _build.check_operand("k", "x", x, (4, 6), torch.float32, dev)
    for bad in (x.double(), x.T, x[:, :5]):
        with pytest.raises(ValueError, match="k kernel: x must be a contiguous"):
            _build.check_operand("k", "x", bad, (4, 6), torch.float32, dev)
    with pytest.raises(ValueError, match="k kernel"):
        _build.check_operand("k", "x", x, [4, 6], torch.float32, torch.device("cuda", 0))


# sha256 (first 16 hex digits) of the keep-scale mask over ones, seed 17, as
# the port gave it before the launch path was shortened (the same Philox
# counters, key, threshold and f32 scale): (rate, m, n, row_offset, site)
RECORDED_MASKS = {
    (0.1, 65, 512, 0, 0): "ae7b695f4b2551c5", (0.1, 65, 512, 0, 1): "a54bb69e55caff1c",
    (0.1, 37, 21, 3, 1): "8e44ff3a03c0b0c0", (0.2, 65, 512, 0, 0): "cd46db48a361f090",
    (0.2, 65, 512, 0, 1): "a1cf27c08b095e47", (0.2, 37, 21, 3, 1): "2420ac7f4688226f",
    (0.25, 65, 512, 0, 0): "30936a08d0008126", (0.25, 65, 512, 0, 1): "bfcbe86d7b4eb86f",
    (0.25, 37, 21, 3, 1): "4d7195004f2e18ef",
}
# (integer threshold, keep scale rounded to f32) the kernel was given per rate
RECORDED_THRESHOLDS = {0.1: (429496730, 1.1111111640930176), 0.2: (858993459, 1.25),
                  0.25: (1073741824, 1.3333333730697632)}


@pytest.mark.parametrize("case", sorted(RECORDED_MASKS),
                         ids=lambda c: "r{}_{}x{}_row{}_site{}".format(*c))
def test_dropout_masks_and_memoised_arguments_match_the_recorded_ones(case):
    rate, m, n, row_offset, site = case
    keep = dp.dropout_plain(torch.ones(m, n), 17, rate, row_offset, site)
    assert hashlib.sha256(keep.numpy().tobytes()).hexdigest()[:16] == RECORDED_MASKS[case]
    thr, scale, stream = dp._site_args(rate, site)
    assert (thr, float(torch.tensor(scale, dtype=torch.float32))) == RECORDED_THRESHOLDS[rate]
    assert (thr, scale) == prng.threshold(rate) and stream == 2 ** 31 + site
    assert dp._site_args(rate, site) is dp._site_args(rate, site)   # memoised
