"""Values read from the card into Python: a frozen copy of
``dpgo_ros_tpu_torch/scripts/common.py::host_reads``.

A TorchFunctionMode counts the calls of a Tensor method that hands a value
to the host (``cpu``, ``to`` the CPU, ``tolist``, ``item``,
``float``/``int``/``bool``/``index``, ``torch.equal``) on a tensor on the
given device. A read inside a C++ operation (the size of a ``nonzero``) is
not seen.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_READS = {"cpu", "tolist", "item", "__float__", "__int__", "__bool__", "__index__",
          "equal"}


def _is_cpu(x) -> bool:
    return isinstance(x, (str, torch.device)) and torch.device(x).type == "cpu"


class ReadCounter(TorchFunctionMode):
    """``with ReadCounter(device) as c: ...`` then ``c.reads``."""

    def __init__(self, device):
        super().__init__()
        self.type, self.reads = torch.device(device).type, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _READS or (name == "to" and any(
                _is_cpu(x) for x in (*args[1:], kwargs.get("device")))):
            if any(isinstance(x, torch.Tensor) and x.device.type == self.type
                   for x in args):
                self.reads += 1
        return func(*args, **kwargs)
