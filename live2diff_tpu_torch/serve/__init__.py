"""The demo server of the port and its host-side JPEG runtime."""
