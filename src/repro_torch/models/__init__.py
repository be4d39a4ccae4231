"""The LM stack of the port: configs (:mod:`.config`), layers, the
decoder-only transformer for the dense attention archs, and ``--arch``
resolution (:mod:`.registry`)."""
from .registry import get_model, list_archs

__all__ = ["get_model", "list_archs"]
