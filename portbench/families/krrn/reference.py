"""KRRN's reference half: the plain fp32 KRRN (HRNet, the XYZ/NML heads,
FusionNetLite, PoseNet), its pool of frames, its loss, one step for the
FLOP count and its tiny CPU cut. Imports nothing of the program."""

from __future__ import annotations

from portbench.gen.pool import krrn_pool
from portbench.reference.krrn import KRRN
from portbench.reference.train import krrn_loss


def reference_model(cfg_file: dict, q):
    if cfg_file.get("fusion_variant", "lite") != "lite":
        raise ValueError("the reference KRRN has FusionNetLite only")
    return KRRN(cfg_file["schema"], q)


def pool(schema: dict, mix: dict, seed: int) -> list:
    return krrn_pool(schema, mix, seed, mix["driver"] == "serve")


def loss(model, schema: dict, batch: dict, gen):
    """The training loss, the forward's draws from `gen` in the
    program's order."""
    out = model(batch["img"], batch["cloud"], batch["choose"], batch["cls"],
                generator=gen)
    return krrn_loss(out, batch, schema["train"]["loss"])


def flop_step(model, schema: dict, batch: dict, train: bool):
    """The forward of one step without draws, and its loss when `train`."""
    out = model(batch["img"], batch["cloud"], batch["choose"], batch["cls"])
    return krrn_loss(out, batch, schema["train"]["loss"]) if train else None


def tiny(schema: dict):
    """Cut `schema` in place to a CPU size."""
    schema["module"].update(
        num_cls=3, backbone_outc=16, stem_width=8,
        hrnet_stages=[[1, 1, [8, 8]], [1, 1, [8, 8, 16]],
                      [1, 1, [8, 8, 16, 16]]],
        xyznet={"hidden": 16, "out": 3}, nmlnet={"hidden": 16, "out": 3},
        gcn3d={"neighbor_num": 4, "support_num": 2})
    schema["data"].update(num_regions=8, num_points=128, input_size=64)
    schema["eval"].update(num_pnp_points=64, pnp_hypotheses=8)
