"""Norm call shapes shared by the CPU route tests and the card tests."""

# the KL codec's GroupNorm calls of a 512x512 stream step, [B, T, C]: the
# encode of the frame and its depth image (B = 2), then the decode (B = 1)
GN_CODEC_SHAPES = [
    (2, 262144, 128), (2, 65536, 128), (2, 65536, 256), (2, 16384, 256), (2, 16384, 512),
    (2, 4096, 512), (1, 4096, 512), (1, 16384, 512), (1, 65536, 512), (1, 65536, 256),
    (1, 262144, 256), (1, 262144, 128),
]
