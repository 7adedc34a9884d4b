"""Cluster pieces the port's engine uses: metrics and tracing."""
