"""The plain reference of the fit path, in PyTorch and NumPy.

It imports nothing of the program under test and takes nothing the program
made: it reads the benchmark's own input tables and, only to judge them, the
program's outputs. Everything is computed in float64 (TF32 is off for any
float32 product), in blocks of rows so that it fits beside the tables.
"""
