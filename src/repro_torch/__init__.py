"""PyTorch/CUDA port of the memory-tiering tuning system.

``repro_torch.core`` holds the typed experiment API (``Study``,
``ExperimentSpec``), the torch epoch loop and the SMAC tuner;
``repro_torch.kernels`` the hand-written CUDA kernels, their plain PyTorch
versions and the dispatch between them; ``repro_torch.configs``,
``.models``, ``.serve`` and ``.launch`` the LM serving stack (configs, the
dense attention transformer, the prefill and decode steps, the serving
launcher).  The package imports ``torch`` and numpy only; it runs on CUDA
by default and on the CPU when asked (``SimOptions(device="cpu")``,
``device="cpu"``).
"""
