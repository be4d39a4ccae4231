"""The benchmark of the PyTorch port of the tiering simulator
(``repro_torch``): see README.md."""

import importlib
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str):
    """``tierbench/<kind>/<name>.py`` as a module of this package, where
    ``kind`` is a dotted subpackage (``"drivers"``, ``"reference.engines"``).
    The file is loaded by path: names may hold dots and dashes."""
    path = HERE.joinpath(*kind.split(".")) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(HERE.parent)}")
    importlib.import_module(f"{__name__}.{kind}")
    safe = "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(
        f"{__name__}.{kind}.{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
