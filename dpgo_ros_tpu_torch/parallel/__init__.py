"""The multi-robot RBCD engine and the asynchronous ASAPP engine."""
