"""The benchmark harness: signal, reference pool, device trace, runner."""
