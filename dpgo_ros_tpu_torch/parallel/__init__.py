"""The multi-robot RBCD engine."""
