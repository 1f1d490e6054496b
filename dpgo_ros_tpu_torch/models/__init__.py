"""Problem container and local Riemannian solvers."""
