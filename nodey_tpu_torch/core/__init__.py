"""Core runtime: stream values, registry, graph, compiler, runner."""
