"""The multi-view engine as ``cli stereo`` calls it: ``mvs_depth_maps`` on
one frame of every view, the batched functions (no checkpoint, no depth
group), WTA or, with the flow ``mrf``, the top-K lists and TRW-S; then the
any-view cross-check.  A request's answer is the depth maps [V, H, W]."""

from __future__ import annotations

def build(config, flow, rig, device):
    """(request(rgbs, masks) -> answer, items a request)."""
    from stereoreconstruction_tpu_torch.config import (MultiViewConfig,
                                                       WeightConfig)
    from stereoreconstruction_tpu_torch.geometry.camera import make_camera
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_depth_maps)

    s = dict(config["settings"])
    cfg = MultiViewConfig(weights=WeightConfig(**s.pop("weights")),
                          use_mrf=flow == "mrf", **s)
    cams = [make_camera(c["K"], c["R"], c["t"], plane_normal=c["normal"],
                        plane_dist=c["plane_dist"],
                        refr_index=c["refr_index"]) for c in rig]

    def request(rgbs, masks):
        return mvs_depth_maps(rgbs, masks, cams, cfg, device=device)

    return request, len(rig)


def answer_maps(answer):
    """The depth maps [V, H, W] of an answer."""
    return answer
