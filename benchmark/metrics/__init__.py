"""Per-layer metric readers, one module a family: `<family>.py` reads
every metric named `<family>.<variant>` through `read(ctx, variant)`,
where `ctx` is `benchmark.harness.Context`. A reader that finds nothing
to read returns None, and the metric is left out of the result."""
