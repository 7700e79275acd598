"""Dataset and submission converters: FAIR -> DOTA, SSDD -> DOTA, and
merged DOTA submissions -> FAIR XML / FAIR1M-1.5 csv.

Port of `jdet_tpu/data/devkits/converters.py` (`fair_xml_to_dota_txt`
:26, `fair_to_dota` :47, `ssdd_xml_to_dota_txt` :79, `ssdd_to_dota` :107,
`_pick_res` :137, `dota_to_fair` :208, `dota_to_fair1m_1_5` :233,
`finalize_submission` :253). The text and XML plumbing is the
reference's, so label files and submissions are equal byte for byte. The
reference reads images with `cv2.imread` and writes them with
`cv2.imwrite`; here `data/image_io.py` reads them (TIFF for FAIR, JPEG
for SSDD: the same pixels as cv2) and writes PNG, and SSDD's resize is
`transforms.resize_linear`, cv2's INTER_LINEAR to the last bit, so the
PNGs decode to the reference's pixels. cv2 reads and writes BGR and the
port RGB, so in both a PNG holds its source's colours.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from ..image_io import imread, imwrite
from ..transforms import resize_linear


def fair_xml_to_dota_txt(src_xml, tar_txt):
    """One FAIR label XML -> one DOTA labelTxt."""
    root = ET.parse(src_xml).getroot()
    lines = ["imagesource:GoogleEarth", "gsd:0.0"]
    objects = root.find("objects")
    if objects is not None:
        for obj in objects.findall("object"):
            name = obj.find("possibleresult").find("name").text.strip()
            name = name.replace(" ", "_")
            pts = obj.find("points").findall("point")
            coords = []
            for p in pts[:4]:
                x, y = p.text.split(",")[:2]
                coords += [float(x), float(y)]
            lines.append(" ".join(str(c) for c in coords) + f" {name} 0")
    with open(tar_txt, "w") as f:
        f.write("\n".join(lines) + "\n")


def fair_to_dota(in_path, out_path):
    """FAIR layout (images/ + labelXml/) -> DOTA layout (images/ PNG +
    labelTxt/), names re-keyed P%04d."""
    os.makedirs(os.path.join(out_path, "images"), exist_ok=True)
    for root, _, files in os.walk(os.path.join(in_path, "images")):
        for f in sorted(files):
            tar = os.path.join(out_path, "images", "P" + os.path.splitext(f)[0].zfill(4) + ".png")
            imwrite(tar, imread(os.path.join(root, f)))

    label_dir = os.path.join(in_path, "labelXml")
    if os.path.exists(label_dir):
        os.makedirs(os.path.join(out_path, "labelTxt"), exist_ok=True)
        for root, _, files in os.walk(label_dir):
            for f in sorted(files):
                tar = os.path.join(out_path, "labelTxt",
                                   "P" + os.path.splitext(f)[0].zfill(4) + ".txt")
                fair_xml_to_dota_txt(os.path.join(root, f), tar)


def ssdd_xml_to_dota_txt(xml_path, txt_path, rescale, plus):
    """One SSDD annotation XML -> DOTA labelTxt. `plus` reads the
    rotated_bndbox 8-coordinate polygon; otherwise the axis-aligned
    bndbox becomes a 4-corner polygon."""
    root = ET.parse(xml_path).getroot()
    sx, sy = rescale
    lines = []
    for ob in root.findall("object"):
        if plus:
            box = ob.find("rotated_bndbox")
            c = [float(box.find(k).text) * (sx if k[0] == "x" else sy)
                 for k in ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4")]
        else:
            box = ob.find("bndbox")
            xmin = float(box.find("xmin").text) * sx
            ymin = float(box.find("ymin").text) * sy
            xmax = float(box.find("xmax").text) * sx
            ymax = float(box.find("ymax").text) * sy
            c = [xmin, ymin, xmin, ymax, xmax, ymax, xmax, ymin]
        name = ob.find("name").text.strip()
        diff = ob.find("difficult").text.strip()
        lines.append(" ".join(str(v) for v in c) + f" {name} {diff}")
    with open(txt_path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def ssdd_to_dota(img_path, anno_path, target_path, resize, plus):
    """SSDD jpg + xml -> DOTA PNG + labelTxt, resized to (resize, resize)."""
    out_img = os.path.join(target_path, "images")
    out_anno = os.path.join(target_path, "labelTxt")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_anno, exist_ok=True)
    for root, _, files in os.walk(img_path):
        for f in sorted(files):
            if not f.endswith(".jpg"):
                continue
            name = f[:-4]
            img = imread(os.path.join(root, f))
            h, w = img.shape[:2]
            imwrite(os.path.join(out_img, name + ".png"), resize_linear(img, (resize, resize)))
            ssdd_xml_to_dota_txt(
                os.path.join(anno_path, name + ".xml"),
                os.path.join(out_anno, name + ".txt"),
                (resize / w, resize / h),
                plus,
            )


# DOTA submission -> FAIR submission -------------------------------------------

def _pick_res(txt_dir, images_dir, keep_underline=False):
    """Group merged per-class submission txts by image; every test image
    gets a (possibly empty) entry."""
    res = {}
    if images_dir and os.path.isdir(images_dir):
        for root, _, files in os.walk(images_dir):
            for f in files:
                if f.endswith((".png", ".tif", ".jpg")):
                    res[f.split("__")[0].split(".")[0]] = []
    for root, _, files in os.walk(txt_dir):
        for f in sorted(files):
            if not f.endswith(".txt"):
                continue
            cls = f[:-4] if keep_underline else f[:-4].replace("_", " ")
            with open(os.path.join(root, f)) as fh:
                for line in fh.read().splitlines():
                    parts = line.split(" ")
                    if len(parts) < 10:
                        continue
                    img, score = parts[0], float(parts[1])
                    box = [float(v) for v in parts[2:10]]
                    res.setdefault(img, []).append(
                        {"cls": cls, "p": score, "box": box}
                    )
    return res


# provider and author as the reference writes them, so that the XML files
# are equal byte for byte
_FAIR_XML_TMPL = """<?xml version="1.0" encoding="utf-8"?>
<annotation>
    <source>
        <filename>{filename}</filename>
        <origin>GF2/GF3</origin>
    </source>
    <research>
        <version>4.0</version>
        <provider>jdet_tpu</provider>
        <author>jdet_tpu</author>
        <pluginname>oriented-detection</pluginname>
        <pluginclass>detection</pluginclass>
        <time>2020-07-2020-11</time>
    </research>
    <size>
        <width>{width}</width>
        <height>{height}</height>
        <depth>3</depth>
    </size>
    <objects>
{objects}    </objects>
</annotation>
"""

_FAIR_OBJ_TMPL = """        <object>
            <coordinate>pixel</coordinate>
            <type>rectangle</type>
            <description>None</description>
            <possibleresult>
                <name>{cls}</name>
                <probability>{prob}</probability>
            </possibleresult>
            <points>
                <point>{p0}</point>
                <point>{p1}</point>
                <point>{p2}</point>
                <point>{p3}</point>
                <point>{p0}</point>
            </points>
        </object>
"""


def dota_to_fair(txt_dir, tar_path, images_dir, size=(1000, 1000)):
    """Merged DOTA submission txts -> per-image FAIR XMLs. File keys
    P0012 -> 12.xml / 12.tif."""
    data = _pick_res(txt_dir, images_dir)
    os.makedirs(tar_path, exist_ok=True)
    for key, objs in data.items():
        stem = str(int(key[1:])) if key[:1] == "P" and key[1:].isdigit() else key
        parts = []
        for o in objs:
            b = o["box"]
            parts.append(
                _FAIR_OBJ_TMPL.format(
                    cls=o["cls"], prob=o["p"],
                    p0=f"{b[0]}, {b[1]}", p1=f"{b[2]}, {b[3]}",
                    p2=f"{b[4]}, {b[5]}", p3=f"{b[6]}, {b[7]}",
                )
            )
        xml = _FAIR_XML_TMPL.format(
            filename=stem + ".tif", width=size[0], height=size[1],
            objects="".join(parts),
        )
        with open(os.path.join(tar_path, stem + ".xml"), "w") as f:
            f.write(xml)


def dota_to_fair1m_1_5(txt_dir, tar_path, images_dir, name):
    """Merged DOTA submission txts -> one FAIR1M-1.5 csv."""
    data = _pick_res(txt_dir, images_dir, keep_underline=True)
    os.makedirs(tar_path, exist_ok=True)
    lines = []
    for key, objs in data.items():
        stem = str(int(key[1:])) if key[:1] == "P" and key[1:].isdigit() else key
        for o in objs:
            b = o["box"]
            lines.append(
                "{},{},{:.4f},{:.4f},{:.4f},{:.4f},{:.4f},{:.4f},{:.4f},"
                "{:.4f},{:.4f}\n".format(stem + ".tif", o["cls"], *b, o["p"])
            )
    out = os.path.join(tar_path, f"{name}.csv")
    with open(out, "w") as f:
        f.writelines(lines)
    return out


def finalize_submission(txt_dir, work_dir, name, dataset_type,
                        images_dir="", zip_path=None):
    """Post-merge submission packaging: DOTA flavours zip the txts; FAIR
    converts to per-image XML under test/ and zips that; FAIR1M_1_5 writes
    a csv. Returns the artifact's path."""
    import zipfile

    os.makedirs(work_dir, exist_ok=True)
    if dataset_type == "FAIR":
        fair_dir = os.path.join(work_dir, "final_fair", "test")
        dota_to_fair(txt_dir, fair_dir, images_dir)
        zip_path = zip_path or os.path.join(work_dir, name + ".zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            for f in sorted(os.listdir(fair_dir)):
                z.write(os.path.join(fair_dir, f), os.path.join("test", f))
        return zip_path
    if dataset_type == "FAIR1M_1_5":
        return dota_to_fair1m_1_5(txt_dir, work_dir, images_dir, name)
    zip_path = zip_path or os.path.join(work_dir, name + ".zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(os.listdir(txt_dir)):
            if f.endswith(".txt"):
                z.write(os.path.join(txt_dir, f), f)
    return zip_path
