from .loader import CudaLoader, find_nvcc

__all__ = ["CudaLoader", "find_nvcc"]
