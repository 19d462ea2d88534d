"""Configuration — the reference's 9-knob PlugInVals re-expressed as a dataclass.

Reference: `src/main.h:12-22` (PlugInVals), defaults `src/main.c:30-40`:
  edges=0.0, textures=1.0, blocksize=8, seams_number=0, new_layer=FALSE,
  resize_canvas=TRUE, output_energy=FALSE, output_seams=FALSE, vertically=FALSE.

`new_layer`/`resize_canvas` are GIMP-layer concerns with no analog here
(documented n/a per SURVEY §5); the remaining knobs keep their exact meaning.
Execution knobs live in separate fields and do not affect results.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CarverConfig:
    # --- reference knobs (src/main.h:12-22, defaults src/main.c:30-40) ---
    edges: float = 0.0          # weight if argmax atom is (0,1)/(1,0)
    textures: float = 1.0       # weight otherwise
    blocksize: int = 8          # DCT block size: 2, 4, 8 or 16
    seams_number: int = 0       # signed: <0 remove, >0 insert (src/render.c:358-364)
    output_energy: bool = False # also produce the normalized energy image
    output_seams: bool = False  # also produce the seam visibility map
    vertically: bool = False    # retarget HEIGHT instead of width
    # resize_canvas=FALSE analog (src/main.h:19, gimp_image_resize at
    # src/render.c:386-392): keep the ORIGINAL canvas size — a removal
    # places the carved layer at the top-left with the vacated region
    # zero-filled; an enlargement is cropped to the canvas.  (The
    # remaining PlugInVals field, new_layer, is a GIMP layer-stack concern
    # with no analog here.)
    resize_canvas: bool = True

    # --- liblqr lqr_carver_init generalization (src/render.c:313 uses 1, 0) ---
    delta_x: int = 1            # max seam step per row (>= 1)
    rigidity: float = 0.0       # step penalty: rigidity * |dx| / delta_x
    # DP tie rule (the S1/S2 spec knob, docs/PARITY.md): the real convention
    # lives inside external liblqr; either can be matched with this flag,
    # applied identically in oracle / native C++ / scan / GPU kernel / spatial.
    tie: str = "leftmost"       # "leftmost" | "rightmost"

    # --- lqr_carver_set_energy_function analog (src/render.c:314-315) ---
    # None/'dct' = the reference's DCT energy (blocksize/edges/textures);
    # a builtin name ('grad_xabs'/'grad_sumabs'/'grad_norm'/'null') or an
    # ops.energy_fn.EnergyFunction plugs a different energy into the carver.
    energy: object = None

    # --- framework knobs (no effect on carve results) ---
    luma: str = "bt709"         # "bt709" (carve path) | "bt601_studio" (preview)
    strip_update: bool = True   # incremental energy updates between seams
    row_block: int | None = None  # bound energy-map peak memory
    # execution routing: "none" = single device; "spatial" = column-shard
    # ONE image over the device mesh (parallel.spatial — BASELINE config 5);
    # "batch" = data-parallel over an image STACK (api.carve with a
    # (B, H, W[, C]) input / parallel.mesh.carve_batch); "auto" = spatial
    # when >1 device is visible (batch for 4-D stacks), else none.
    # Seams are identical on every route (asserted in tests).
    parallel: str = "none"

    def __post_init__(self):
        if self.blocksize not in (2, 4, 8, 16):
            raise ValueError(f"blocksize must be 2/4/8/16, got {self.blocksize}")
        if not (0 <= self.edges <= 1 and 0 <= self.textures <= 1):
            # reference sliders span [0,1] (src/interface.c:631-639)
            raise ValueError("edges/textures must be in [0, 1]")
        if self.delta_x < 1:
            raise ValueError(f"delta_x must be >= 1, got {self.delta_x}")
        if self.rigidity < 0:
            raise ValueError(f"rigidity must be >= 0, got {self.rigidity}")
        if self.tie not in ("leftmost", "rightmost"):
            raise ValueError(
                f"tie must be 'leftmost' or 'rightmost', got {self.tie!r}")
        if self.parallel not in ("none", "batch", "spatial", "auto"):
            raise ValueError(
                f"parallel must be none/batch/spatial/auto, got "
                f"{self.parallel!r}")
        self.energy_function  # validates the energy spec eagerly

    @property
    def radius(self) -> int:
        """liblqr energy-function radius = blocksize/2 (src/render.c:314-315),
        or the plugged energy function's own radius."""
        fn = self.energy_function
        return fn.radius if fn is not None else self.blocksize // 2

    @property
    def energy_function(self):
        """The resolved EnergyFunction, or None for the default DCT energy."""
        from ..ops.energy_fn import resolve_energy

        return resolve_energy(self.energy)
