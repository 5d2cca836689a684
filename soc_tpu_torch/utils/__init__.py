"""Host utilities: mid-run checkpoint/resume (``checkpoint``) and a block
of kernels replayed as one CUDA graph (``graphs``)."""
