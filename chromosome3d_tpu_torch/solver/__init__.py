# the float32 matmul settings (device.py) hold wherever this package computes
from chromosome3d_tpu_torch import device as _device  # noqa: F401
