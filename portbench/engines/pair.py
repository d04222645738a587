"""The two-view engine as ``cli stereo --two-view`` calls it:
``twoview.compute_depth_maps`` on views 0 and 1 of one frame, the kernel
method, WTA or, with the flow ``mrf``, the dense cost volume and BP; then
the symmetric cross-check.  A request's answer is both depth maps."""

from __future__ import annotations

def build(config, flow, rig, device):
    """(request(rgbs, masks) -> answer, items a request)."""
    from stereoreconstruction_tpu_torch.config import (TwoViewConfig,
                                                       WeightConfig)
    from stereoreconstruction_tpu_torch.geometry.camera import make_camera
    from stereoreconstruction_tpu_torch.stereo import twoview

    s = dict(config["settings"])
    cfg = TwoViewConfig(weights=WeightConfig(**s.pop("weights")), **s)
    cams = [make_camera(c["K"], c["R"], c["t"], plane_normal=c["normal"],
                        plane_dist=c["plane_dist"],
                        refr_index=c["refr_index"]) for c in rig]
    use_mrf = flow == "mrf"

    def request(rgbs, masks):
        return twoview.compute_depth_maps(
            rgbs[0], masks[0], rgbs[1], masks[1], cams[0], cams[1], cfg,
            use_mrf=use_mrf, device=device)

    return request, 1


def answer_maps(answer):
    """The depth maps [2, H, W] of an answer."""
    import torch
    return torch.stack([answer.depth_left, answer.depth_right])
