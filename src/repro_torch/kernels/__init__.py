"""Hand-written CUDA kernels of the port, their plain torch versions, the
device dispatch (:mod:`.ops`), the numpy references (:mod:`.ref`) and the
build step (:mod:`.build`). Nothing is compiled at import time."""
