"""Optimizers and learning-rate schedules (the port's copy of the JAX
package's ``optim``)."""
