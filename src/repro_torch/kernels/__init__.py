"""Hand-written CUDA kernels for the paper's FCU, KPU and depthwise units,
for the LM path's blockwise attention and for the SSM path's SSD chunked
scan, built by ``_build`` and bound through ctypes; each module keeps the
kernel's plain PyTorch version beside its wrapper."""
