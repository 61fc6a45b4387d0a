"""Device operations of the stacking paths: statistics, calibration,
detection, registration, warps and the sigma-clip combines, each kernel
beside its plain PyTorch twin."""
