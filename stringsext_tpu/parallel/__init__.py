"""Multi-device scaling: mesh-sharded scanning across devices and
processes."""
