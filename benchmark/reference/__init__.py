"""Plain float32 PyTorch of what the cells run (BAT's schedule and step),
the reference that decides ``correct``.  Imports neither JAX nor the JAX
package nor anything of the port."""
