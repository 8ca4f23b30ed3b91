"""Segment, patch and embed a directory of slides (ref: bin/extract_patch_embeddings.py).

Usage (the JAX package's flags, plus --device and --bag_format):
    python -m madeleine_torch.cli.extract_patch_embeddings --slide_dir <slides> \
        --local_dir <out> [--patch_mag 10] [--patch_size 256] \
        [--encoder handcrafted|conch|vit] [--vit_checkpoint <ckpt>] \
        [--bag_format h5|npz|bag] [--device cuda]

Per slide: tissue segmentation (the Otsu backend; a model backend through
the library, `preprocessing/segmentation.py`), tissue-masked grid patching,
the tiles encoded in batches on the device, and one bag of {features,
coords} under ``<local_dir>/processing_<encoder>_nWSI_<n>_mag_<m>x_patchsize_<p>/
patch_embeddings/``, with the segmentation's artifacts under its
``segmentation/``. Slides are read through PIL (plain image files) or,
where openslide imports, openslide (pyramidal formats). ``--bag_format h5``
(the default, the JAX package's format) needs h5py; the card's machine has
none, so give it ``npz`` or ``bag`` there.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from madeleine_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

EXTENSIONS = (".svs", ".mrxs", ".tiff", ".tif", ".TIFF", ".ndpi",
              ".png", ".jpg", ".jpeg")


def process(slide_dir: str, out_dir: str, patch_mag: int, patch_size: int,
            encoder_name: str, pixel_size: float, vit_checkpoint: Optional[str] = None,
            device=None, bag_format: str = "h5") -> str:
    """Every slide of `slide_dir` -> its bag; returns the processing dir."""
    from madeleine_torch.preprocessing.segmentation import TissueSegmenter
    from madeleine_torch.preprocessing.tile_embedder import (HandcraftedEncoder,
                                                             TileEmbedder,
                                                             make_conch_encoder)
    from madeleine_torch.preprocessing.wsi import get_pixel_size, wsi_factory

    dev = resolve_device(device)
    fnames: List[str] = [fn for fn in os.listdir(slide_dir) if fn.endswith(EXTENSIONS)]
    logger.info("Running segmentation, patching, and feature extraction on "
                "%d slides.", len(fnames))

    out_dir = os.path.join(
        out_dir, f"processing_{encoder_name}_nWSI_{len(fnames)}"
                 f"_mag_{patch_mag}x_patchsize_{patch_size}")
    seg_path = os.path.join(out_dir, "segmentation")
    os.makedirs(seg_path, exist_ok=True)

    if encoder_name == "conch":
        encoder = make_conch_encoder(device=dev)
    elif encoder_name == "vit":
        from madeleine_torch.preprocessing.vit import (TorchViTEncoder,
                                                       load_torch_vision_tower)
        if not vit_checkpoint:
            raise SystemExit("--encoder vit requires --vit_checkpoint "
                             "(torch checkpoint with a visual.* tower)")
        vcfg, tower = load_torch_vision_tower(vit_checkpoint)
        encoder = TorchViTEncoder(vcfg, tower, device=dev)
    else:
        encoder = HandcraftedEncoder(device=dev)
    segmenter = TissueSegmenter(save_path=seg_path, batch_size=64)
    embedder = TileEmbedder(encoder=encoder, target_patch_size=patch_size,
                            target_mag=patch_mag, save_path=out_dir, device=dev,
                            bag_format=bag_format)

    for fn in fnames:
        logger.info("processing %s", fn)
        wsi = wsi_factory(os.path.join(slide_dir, fn))
        px = get_pixel_size(wsi, default=pixel_size)
        bn = os.path.splitext(fn)[0]
        mask, _, _ = segmenter.segment_tissue(wsi, px, save_bn=bn)
        embedder.embed_tiles(wsi, mask, bn, pixel_size=px)

    logger.info("Done")
    return out_dir


def main(argv=None) -> str:
    """Parse the flags and run `process`; returns the processing dir."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--slide_dir", type=str, default=None)
    parser.add_argument("--local_dir", type=str, default="./../data/downstream")
    parser.add_argument("--patch_mag", type=int, default=10)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--encoder", type=str, default="handcrafted",
                        choices=["handcrafted", "conch", "vit"])
    parser.add_argument("--vit_checkpoint", type=str, default=None,
                        help="torch checkpoint with an open_clip visual.* tower")
    parser.add_argument("--pixel_size", type=float, default=0.5,
                        help="fallback MPP when slide metadata lacks it")
    parser.add_argument("--bag_format", type=str, default="h5", choices=["h5", "npz", "bag"],
                        help="h5 needs h5py")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    logger.info("Initiate run...")
    return process(args.slide_dir, args.local_dir, args.patch_mag, args.patch_size,
                   args.encoder, args.pixel_size, args.vit_checkpoint, device=args.device,
                   bag_format=args.bag_format)


if __name__ == "__main__":
    main()
