"""Training of the port: optimizer, train step, FaaS-driven trainer."""
