from .forest_fast import FlatForest, suggest_topq
from .rf import RandomForest
from .smac import SMACOptimizer
from .tuner import TuningSession, TuningResult

__all__ = ["FlatForest", "RandomForest", "SMACOptimizer", "TuningSession",
           "TuningResult", "suggest_topq"]
