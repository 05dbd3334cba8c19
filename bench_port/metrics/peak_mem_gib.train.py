from bench_port.readers import window_peak_gib as read  # noqa: F401
