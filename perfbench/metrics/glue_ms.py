"""glue_ms: device ms a frame of the rows that are not the port's own CUDA
kernels nor the mesh's exchanges: torch's elementwise kernels, copies, fills
and reductions around the walks (the band with the most)."""

PATTERNS = (r".",)
PORT_KERNELS = (r"rebin_tile", r"strip_walk", r"render_kernel", r"hole_fill_pass",
                r"rebin_compact", r"plane_build_kernel", r"nbody", r"splat_cells_kernel")
EXCHANGE = (r"nccl",)


def read(ranks) -> float | None:
    ms = [r.ms_per_frame(PATTERNS, exclude=PORT_KERNELS + EXCHANGE) for r in ranks]
    ms = [t for t in ms if t is not None]
    return max(ms) if ms else None
