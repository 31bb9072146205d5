"""Term banks, matrix functions, the DIA SpMV kernel and the shifted solvers."""
