from .statistics import ComputeModelStatistics

__all__ = ["ComputeModelStatistics"]
