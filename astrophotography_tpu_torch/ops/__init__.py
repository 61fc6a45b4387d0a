"""Device operations of the lean path: detection, registration and the
fused warp+combine, each kernel beside its plain PyTorch twin."""
