"""The plain reference of the benchmark: NumPy and plain PyTorch over the
benchmark's own input files. It imports nothing of the program (the
soc_tpu_torch package) and takes nothing the program made: the solver
data, the simple-dust optics and the octree links are worked out again
from the model files. The program's outputs are read only to judge them.
"""
