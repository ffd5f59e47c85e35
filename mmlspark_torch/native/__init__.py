from .loader import (CudaLoader, NativeBuildError, NativeLoader, find_nvcc,
                     get_httpfront, require_httpfront)

__all__ = ["CudaLoader", "NativeBuildError", "NativeLoader", "find_nvcc",
           "get_httpfront", "require_httpfront"]
