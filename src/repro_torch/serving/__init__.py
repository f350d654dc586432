"""Serving of the port: KV-cache utilities and the continuous-batching engine."""
