"""cufhe_tpu_torch._build.call, the one launch path into the kernel library,
with a fake library in place of the ctypes one: no card and no build."""
import types

import pytest
import torch

from cufhe_tpu_torch import _build


class _FakeLib:
    """One launch entry that records its arguments and returns `rc`."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def cufhe_rotdec(self, *args):
        self.calls.append(args)
        return self.rc

    def cufhe_error_string(self, rc):
        return b"invalid argument"


class _FakeDevice:
    """torch.cuda.device: records the device and whether it is entered."""
    entered = []
    inside = False

    def __init__(self, device):
        self.entered.append(device)

    def __enter__(self):
        _FakeDevice.inside = True

    def __exit__(self, *exc):
        _FakeDevice.inside = False


def _current_stream():
    assert _FakeDevice.inside, "the stream is read outside the device"
    return types.SimpleNamespace(cuda_stream=0xBEEF)


@pytest.mark.parametrize("rc", [0, 1])
def test_call_passes_the_stream_last_and_raises_naming_the_entry(
        rc, monkeypatch):
    """call enters the device, passes its current stream's handle after the
    arguments, and turns a nonzero code into a RuntimeError naming the
    entry and cufhe_error_string's message."""
    lib = _FakeLib(rc)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_FakeDevice, "entered", [])
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", _current_stream)
    dev = torch.device("cuda", 1)
    if rc:
        with pytest.raises(RuntimeError, match=r"^cufhe_rotdec failed: "
                                               r"invalid argument \(1\)$"):
            _build.call("cufhe_rotdec", dev, 11, 22)
    else:
        assert _build.call("cufhe_rotdec", dev, 11, 22) is None
    assert lib.calls == [(11, 22, 0xBEEF)]
    assert _FakeDevice.entered == [dev] and not _FakeDevice.inside
