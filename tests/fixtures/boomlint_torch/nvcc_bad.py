"""Seeded PL001: a build that flushes denormals."""
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--use_fast_math", "-shared", "-Xptxas", "-v")
