"""Host utilities: mid-run checkpoint/resume (``checkpoint``), a block
of kernels replayed as one CUDA graph (``graphs``) and the program's
tracer of spans and counters (``trace``)."""
