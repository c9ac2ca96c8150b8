"""Affine geometry, the device crops (with the rotation-resample kernel),
heatmap targets, decoders, OKS and the fused layer1 Bottleneck-chain
kernel."""
