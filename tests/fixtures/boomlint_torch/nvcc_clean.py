"""Clean twin of nvcc_bad: IEEE denormals, division and square roots."""
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-shared", "-Xptxas", "-v")
