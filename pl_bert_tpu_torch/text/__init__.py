"""The phoneme symbol table (symbols.py), a copy of the JAX package's."""
