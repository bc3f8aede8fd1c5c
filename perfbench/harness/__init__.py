"""The harness: spec, traffic, system, window, trace and check."""
