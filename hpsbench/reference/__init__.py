"""The plain reference of the benchmark: NumPy only.

It imports neither JAX nor either HPS package and takes nothing the program
made: it re-derives the int8 rows from the fp32 tables the harness
generated. ``reference/<kind>.py`` serves the configurations of that kind.
"""
