"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (:mod:`.ref`) and the dispatch by tensor device (:mod:`.ops`).
Importing this package builds nothing: a kernel is compiled and loaded on
its first launch, or by :func:`.build.build`."""
