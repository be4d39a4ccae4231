from .forest_fast import FlatForest, suggest_topq
from .rf import RandomForest
from .smac import SMACOptimizer
from .tuner import TuningSession, TuningResult
from .importance import knob_importance

__all__ = ["FlatForest", "RandomForest", "SMACOptimizer", "TuningSession",
           "TuningResult", "knob_importance", "suggest_topq"]
