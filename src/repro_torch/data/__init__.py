from .pipeline import DataState, SyntheticLM

__all__ = ["SyntheticLM", "DataState"]
