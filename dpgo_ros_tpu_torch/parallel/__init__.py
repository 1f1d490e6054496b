"""The multi-robot RBCD engine, the asynchronous ASAPP engine, and the fleet
protocol simulation (agents, controller, transports, front-end service)."""
