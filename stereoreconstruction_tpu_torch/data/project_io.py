"""Project file I/O.

Reads and writes the reference's ``project.xml`` format (the checkpoint format
of the whole pipeline): cameras with projection matrix / lens distortion /
response curves / refractive interface, image sets, feature sets and
correspondence sets.  Parity targets:

* load:  project/project.cpp:74-327
* save:  project/project.cpp:331-535 (attribute names, element order,
         omit-if-zero rules)
* schema: project/project.xsd (structural constraints re-checked here without
         Qt XmlPatterns)

The loaded ``ProjectData`` is a plain host-side object registry (like the
reference's ``Project``); ``CameraRecord.to_camera()`` produces the
``geometry.Camera`` of float64 tensors used by the stereo engines.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera import decompose_P, make_camera, Camera


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclass
class FeatureRecord:
    """One 2D feature (features/feature.hpp:27-60).

    ``kind`` is "checkerboard" or "surf"; checkerboard features carry the
    corner index + image-set id used by their ``compare`` (checkerboard.cpp:
    63-71), surf features may carry a descriptor (the reference leaves
    descriptor persistence unimplemented, surf.cpp:41-50 — we persist it as an
    extension attribute when present).
    """

    x: float
    y: float
    kind: str = "checkerboard"
    corner_index: int = -1
    image_set_id: str = ""
    descriptor: Optional[np.ndarray] = None


@dataclass
class ImageRecord:
    file: str                 # absolute path
    camera_id: str
    is_default: bool = True
    exposure: float = -1.0


@dataclass
class ImageSetRecord:
    id: str
    name: str
    root: str                 # absolute directory
    images: List[ImageRecord] = field(default_factory=list)

    def default_image_for_camera(self, camera_id: str) -> Optional[ImageRecord]:
        """ImageSet::defaultImageForCamera (imageset.hpp:39-104)."""
        fallback = None
        for img in self.images:
            if img.camera_id == camera_id:
                if img.is_default:
                    return img
                fallback = fallback or img
        return fallback


@dataclass
class CameraRecord:
    id: str
    name: str
    P: np.ndarray                       # [3, 4]
    dist: np.ndarray                    # [5] k1 k2 p1 p2 k3
    response: Optional[np.ndarray] = None   # [256, 3] or None
    refr_px: float = 0.0
    refr_py: float = 0.0
    refr_dist: float = 0.0
    refr_index: float = 1.0

    def decompose(self):
        return decompose_P(self.P)

    def plane_normal_local(self) -> np.ndarray:
        """Interface normal in the local frame: K^-1 (px, py, 1) normalized
        (project.cpp:180-181)."""
        K, _, _, _ = self.decompose()
        n = np.linalg.solve(K, np.array([self.refr_px, self.refr_py, 1.0]))
        return n / np.linalg.norm(n)

    def to_camera(self, dtype=torch.float64, device="cpu") -> Camera:
        K, R, t, _ = self.decompose()
        plane_normal = None
        if abs(self.refr_index - 1.0) > 1e-10 and abs(self.refr_dist) > 1e-10:
            plane_normal = self.plane_normal_local()
        return make_camera(
            K, R, t, dist=self.dist,
            plane_normal=plane_normal,
            plane_dist=self.refr_dist,
            refr_index=self.refr_index,
            dtype=dtype, device=device,
        )


PairKey = Tuple[str, str, str, str]  # imageSet1, camera1, imageSet2, camera2


@dataclass
class ProjectData:
    path: str = ""
    cameras: Dict[str, CameraRecord] = field(default_factory=dict)
    image_sets: Dict[str, ImageSetRecord] = field(default_factory=dict)
    # (imageSetId, cameraId) -> features
    features: Dict[Tuple[str, str], List[FeatureRecord]] = field(
        default_factory=dict)
    # (imageSet1, camera1, imageSet2, camera2) -> [(index1, index2), ...]
    correspondences: Dict[PairKey, List[Tuple[int, int]]] = field(
        default_factory=dict)

    def correspondences_for(self, image_set1, camera1, image_set2, camera2):
        """Symmetric pair lookup returning (pairs, swapped) — FeatureDatabase
        semantics (featuredb.cpp:40-77)."""
        key = (image_set1, camera1, image_set2, camera2)
        if key in self.correspondences:
            return self.correspondences[key], False
        rkey = (image_set2, camera2, image_set1, camera1)
        if rkey in self.correspondences:
            return self.correspondences[rkey], True
        return [], False


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def _get(el, name, default=None):
    v = el.get(name)
    return default if v is None else v


def load_project(path: str, validate: bool = True) -> ProjectData:
    """Parse project.xml (project.cpp:74-327).

    ``validate`` checks the file against the structural equivalent of the
    reference's XSD contract first (project/project.cpp:80-91 validates
    against project/project.xsd before parsing) and raises
    :class:`.schema.ProjectValidationError`
    on malformed input."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "project":
        raise ValueError(f"not a project file: root element <{root.tag}>")
    if validate:
        from .schema import validate_project_xml
        validate_project_xml(root)

    proj = ProjectData(path=os.path.abspath(path))
    proj_dir = os.path.dirname(proj.path)

    # Cameras
    cameras_el = root.find("cameras")
    if cameras_el is not None:
        for cam_el in cameras_el.findall("camera"):
            cam_id = _get(cam_el, "id", "")
            name = _get(cam_el, "name", cam_id)

            pm = cam_el.find("projectionMatrix")
            P = np.zeros((3, 4))
            P[:, :3] = np.eye(3)
            if pm is not None:
                P = np.array([[float(_get(pm, f"m{r}{c}", "0"))
                               for c in range(1, 5)] for r in range(1, 4)])

            dist = np.zeros(5)
            ld = cam_el.find("lensDistortion")
            if ld is not None:
                # Storage order [k1, k2, p1, p2, k3] (project.cpp:140-150)
                for i, attr in enumerate(("k1", "k2", "p1", "p2", "k3")):
                    dist[i] = float(_get(ld, attr, "0"))

            response = None
            for resp_el in cam_el.findall("response"):
                channel = {"red": 0, "green": 1, "blue": 2}.get(
                    _get(resp_el, "channel", ""), -1)
                if channel < 0:
                    continue
                if response is None:
                    response = np.zeros((256, 3))
                values = resp_el.findall("value")
                for i, v in enumerate(values[:256]):
                    response[i, channel] = float(v.text or "0")

            rec = CameraRecord(id=cam_id, name=name, P=P, dist=dist,
                               response=response)

            refr = cam_el.find("refractiveInterface")
            if refr is not None:
                rec.refr_px = float(_get(refr, "px", "0.0"))
                rec.refr_py = float(_get(refr, "py", "0.0"))
                rec.refr_dist = float(_get(refr, "dist", "0.0"))
                rec.refr_index = float(_get(refr, "refractiveRatio", "1.0"))

            proj.cameras[cam_id] = rec

    # Image sets
    sets_el = root.find("imageSets")
    if sets_el is not None:
        for set_el in sets_el.findall("imageSet"):
            set_id = _get(set_el, "id", "")
            rec = ImageSetRecord(
                id=set_id,
                name=_get(set_el, "name", set_id),
                root=proj_dir,
            )
            set_root = _get(set_el, "root")
            if set_root is not None:
                rec.root = (set_root if os.path.isabs(set_root)
                            else os.path.join(proj_dir, set_root))
            for img_el in set_el.findall("image"):
                cam_id = _get(img_el, "for", "")
                if cam_id not in proj.cameras:
                    continue
                rec.images.append(ImageRecord(
                    file=os.path.join(rec.root, _get(img_el, "file", "")),
                    camera_id=cam_id,
                    is_default=_get(img_el, "default", "no") == "yes",
                    exposure=float(_get(img_el, "exposure", "-1.0")),
                ))
            if rec.images:
                proj.image_sets[set_id] = rec

    # Feature sets
    fsets_el = root.find("featureSets")
    if fsets_el is not None:
        for fset_el in fsets_el.findall("featureSet"):
            set_id = _get(fset_el, "imageSet", "")
            cam_id = _get(fset_el, "camera", "")
            feats: List[FeatureRecord] = []
            for f_el in fset_el.findall("feature"):
                kind = _get(f_el, "type", "").lower()
                desc_attr = _get(f_el, "descriptor")
                feats.append(FeatureRecord(
                    x=float(_get(f_el, "x", "0")),
                    y=float(_get(f_el, "y", "0")),
                    kind=kind,
                    corner_index=int(_get(f_el, "cindex", "0")),
                    image_set_id=_get(f_el, "imageSet", ""),
                    descriptor=(np.fromstring(desc_attr, sep=" ")
                                if desc_attr else None),
                ))
            if feats:
                proj.features[(set_id, cam_id)] = feats

    # Correspondence sets
    csets_el = root.find("correspondenceSets")
    if csets_el is not None:
        for cset_el in csets_el.findall("correspondenceSet"):
            key = (_get(cset_el, "imageSet1", ""), _get(cset_el, "camera1", ""),
                   _get(cset_el, "imageSet2", ""), _get(cset_el, "camera2", ""))
            pairs = []
            for c_el in cset_el.findall("correspondence"):
                i1 = int(_get(c_el, "index1", "-1"))
                i2 = int(_get(c_el, "index2", "-1"))
                if i1 >= 0 and i2 >= 0:
                    pairs.append((i1, i2))
            if pairs:
                proj.correspondences[key] = pairs

    return proj


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _fmt(x: float) -> str:
    """Qt's default number formatting: shortest round-trip repr."""
    return repr(float(x)) if x != int(x) else str(int(x))


def save_project(proj: ProjectData, path: str) -> None:
    """Serialize to the reference's XML layout (project.cpp:331-535)."""
    proj_dir = os.path.dirname(os.path.abspath(path))
    root = ET.Element("project")

    if proj.cameras:
        cams_el = ET.SubElement(root, "cameras")
        for cam in proj.cameras.values():
            cam_el = ET.SubElement(cams_el, "camera", id=cam.id)
            if cam.name and cam.name != cam.id:
                cam_el.set("name", cam.name)
            pm = ET.SubElement(cam_el, "projectionMatrix")
            for r in range(3):
                for c in range(4):
                    pm.set(f"m{r + 1}{c + 1}", _fmt(cam.P[r, c]))
            names = ("k1", "k2", "p1", "p2", "k3")
            if np.any(np.abs(cam.dist) > 1e-10):
                ld = ET.SubElement(cam_el, "lensDistortion")
                for i, attr in enumerate(names):
                    if abs(cam.dist[i]) > 1e-10:
                        ld.set(attr, _fmt(cam.dist[i]))
            # refractiveInterface before response: project.xsd's sequence
            # puts response last.  (The reference's own writer emits
            # response first, project.cpp:385-413, violating its XSD — the
            # loader therefore accepts either order, see data/schema.py.)
            if (abs(cam.refr_index - 1.0) > 1e-10
                    and abs(cam.refr_dist) > 1e-10):
                refr = ET.SubElement(cam_el, "refractiveInterface")
                refr.set("px", _fmt(cam.refr_px))
                refr.set("py", _fmt(cam.refr_py))
                refr.set("dist", _fmt(cam.refr_dist))
                refr.set("refractiveRatio", _fmt(cam.refr_index))
            if cam.response is not None:
                for ch, chname in enumerate(("red", "green", "blue")):
                    if np.any(np.abs(cam.response[:, ch]) > 1e-10):
                        resp_el = ET.SubElement(cam_el, "response",
                                                channel=chname)
                        for v in cam.response[:, ch]:
                            val_el = ET.SubElement(resp_el, "value")
                            val_el.text = _fmt(v)

    if proj.image_sets:
        sets_el = ET.SubElement(root, "imageSets")
        for iset in proj.image_sets.values():
            set_el = ET.SubElement(sets_el, "imageSet", id=iset.id)
            if os.path.abspath(iset.root) != proj_dir:
                set_el.set("root", os.path.relpath(iset.root, proj_dir))
            if iset.name and iset.name != iset.id:
                set_el.set("name", iset.name)
            for img in iset.images:
                img_el = ET.SubElement(set_el, "image")
                img_el.set("file", os.path.relpath(img.file, iset.root))
                if img.exposure > 0:
                    img_el.set("exposure", _fmt(img.exposure))
                img_el.set("for", img.camera_id)
                if img.is_default:
                    img_el.set("default", "yes")

    if proj.features:
        fsets_el = ET.SubElement(root, "featureSets")
        for (set_id, cam_id), feats in proj.features.items():
            fset_el = ET.SubElement(fsets_el, "featureSet",
                                    imageSet=set_id, camera=cam_id)
            for index, f in enumerate(feats):
                f_el = ET.SubElement(fset_el, "feature")
                f_el.set("x", _fmt(f.x))
                f_el.set("y", _fmt(f.y))
                f_el.set("index", str(index))
                f_el.set("type", f.kind)
                if f.kind == "checkerboard":
                    f_el.set("imageSet", f.image_set_id)
                    f_el.set("cindex", str(f.corner_index))
                elif f.descriptor is not None:
                    f_el.set("descriptor",
                             " ".join(repr(float(v)) for v in f.descriptor))

    if proj.correspondences:
        csets_el = ET.SubElement(root, "correspondenceSets")
        for key, pairs in proj.correspondences.items():
            cset_el = ET.SubElement(csets_el, "correspondenceSet")
            cset_el.set("imageSet1", key[0])
            cset_el.set("camera1", key[1])
            cset_el.set("imageSet2", key[2])
            cset_el.set("camera2", key[3])
            for i1, i2 in pairs:
                ET.SubElement(cset_el, "correspondence",
                              index1=str(i1), index2=str(i2))

    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="unicode")
