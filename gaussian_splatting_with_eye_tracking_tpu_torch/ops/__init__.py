"""Rasterizer ops: transforms, sh, projection (K7), expand (K1), binning (K8),
blend (K2), rasterize."""
