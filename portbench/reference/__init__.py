"""The plain reference that decides ``correct``: PyTorch and numpy only.

Nothing here imports the program (``signaltrain_tpu_torch``), the JAX
package or JAX, and nothing here takes what the program has made: it is
given the seed, the weights that ``portbench/weights.py`` made and the
traffic, and works everything else out again. Each module names the program
file it is a frozen copy of.
"""
