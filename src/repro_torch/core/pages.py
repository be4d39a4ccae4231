"""The page granule (the reference package's ``pages.PAGE_BYTES``);
placement state lives in the epoch loop's carry, see
:mod:`repro_torch.core.engine_torch`."""

PAGE_BYTES = 2 * 1024 * 1024  # 2 MiB huge pages, HeMem's migration granule
