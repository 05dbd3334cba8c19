from bench_port.readers import idle_pct as read  # noqa: F401
