"""Pascal VOC -> YOLO-layout dataset conversion (a copy of
yolo_re_tpu/data/voc.py; tests/test_torch_tooling.py pins the two equal).

The reference ships this inside its Modal launcher (reference:
scripts/train_modal.py:133-283 — `convert_voc_xml_to_yolo` + `download_voc`).
Here the pure conversion logic lives in the library so it is host-runnable
and unit-testable without egress; the download wrapper is
scripts/prepare_voc.py.

Output layout matches what `YOLODataset` expects (images/<split>/*.jpg with
labels/<split>/*.txt siblings, one `cls xc yc w h` normalized row per box).
"""

from __future__ import annotations

import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
_CLASS_INDEX = {name: i for i, name in enumerate(VOC_CLASSES)}


def voc_xml_to_yolo(xml_path: str | Path,
                    keep_difficult: bool = False) -> list[str]:
    """One VOC annotation XML -> YOLO label lines.

    Image dimensions come from the XML <size> element (no image decode
    needed). Objects flagged ``difficult`` are skipped unless
    ``keep_difficult``; objects with names outside the 20 VOC classes are
    skipped. Semantics match reference scripts/train_modal.py:133-182.
    """
    root = ET.parse(str(xml_path)).getroot()
    size = root.find("size")
    if size is None:
        return []
    img_w = int(size.findtext("width", "0"))
    img_h = int(size.findtext("height", "0"))
    if img_w <= 0 or img_h <= 0:
        return []

    lines: list[str] = []
    for obj in root.findall("object"):
        if not keep_difficult and obj.findtext("difficult") == "1":
            continue
        cls_id = _CLASS_INDEX.get(obj.findtext("name", ""))
        if cls_id is None:
            continue
        bbox = obj.find("bndbox")
        if bbox is None:
            continue
        xmin = float(bbox.findtext("xmin", "0"))
        ymin = float(bbox.findtext("ymin", "0"))
        xmax = float(bbox.findtext("xmax", "0"))
        ymax = float(bbox.findtext("ymax", "0"))
        xc = (xmin + xmax) / 2 / img_w
        yc = (ymin + ymax) / 2 / img_h
        w = (xmax - xmin) / img_w
        h = (ymax - ymin) / img_h
        lines.append(f"{cls_id} {xc:.6f} {yc:.6f} {w:.6f} {h:.6f}")
    return lines


def convert_voc_devkit(devkit_dir: str | Path, out_dir: str | Path,
                       years: tuple[str, ...] = ("VOC2007", "VOC2012"),
                       copy_images: bool = True) -> tuple[str, str]:
    """Convert an extracted VOCdevkit tree to the YOLO train/val layout.

    Split rule (matches reference scripts/train_modal.py:239-276): images in
    VOC2007's ImageSets/Main/test.txt become the val split; everything else
    (07 trainval + all of 2012) is train.

    Returns (train_images_dir, val_images_dir).
    """
    devkit = Path(devkit_dir)
    out = Path(out_dir)
    dirs = {}
    for split in ("train", "val"):
        dirs[split, "img"] = out / "images" / split
        dirs[split, "lbl"] = out / "labels" / split
        dirs[split, "img"].mkdir(parents=True, exist_ok=True)
        dirs[split, "lbl"].mkdir(parents=True, exist_ok=True)

    test_file = devkit / "VOC2007" / "ImageSets" / "Main" / "test.txt"
    test_ids: set[str] = set()
    if test_file.exists():
        test_ids = {ln.strip() for ln in test_file.read_text().splitlines()
                    if ln.strip()}

    n = {"train": 0, "val": 0}
    for year in years:
        year_path = devkit / year
        if not year_path.exists():
            continue
        for img_file in sorted((year_path / "JPEGImages").glob("*.jpg")):
            img_id = img_file.stem
            split = ("val" if year == "VOC2007" and img_id in test_ids
                     else "train")
            dest_img = dirs[split, "img"] / img_file.name
            if not dest_img.exists():
                if copy_images:
                    shutil.copy(str(img_file), str(dest_img))
                else:
                    dest_img.symlink_to(img_file.resolve())
            xml_file = year_path / "Annotations" / f"{img_id}.xml"
            if xml_file.exists():
                lines = voc_xml_to_yolo(xml_file)
                if lines:
                    (dirs[split, "lbl"] / f"{img_id}.txt").write_text(
                        "\n".join(lines) + "\n")
            n[split] += 1

    print(f"VOC converted: {n['train']} train, {n['val']} val -> {out}")
    return str(dirs["train", "img"]), str(dirs["val", "img"])
