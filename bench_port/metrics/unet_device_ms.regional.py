from bench_port.spans import unet_device_ms as read  # noqa: F401
