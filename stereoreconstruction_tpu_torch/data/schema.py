"""Structural validation of project.xml — faithful equivalent of the
reference's XSD contract (project/project.xsd, enforced by Qt XmlPatterns
before parsing, project/project.cpp:80-91).

Implements every constraint the 310-line schema expresses, without an XSD
engine:

* element order + multiplicity under <project> (cameras?, imageSets?,
  featureSets?, correspondenceSets? — each at most once, in that order),
* required/typed attributes per element (projectionMatrix m11..m34 doubles,
  refractiveInterface px/py/dist/refractiveRatio, feature type/x/y/index,
  correspondence index1/index2 nonNegative, ...),
* enumerations (image default="yes", response channel red|green|blue),
* response curves: >= 256 <value> doubles, at most 3 per camera,
* key constraints: unique camera ids, unique imageSet ids,
* keyrefs: image@for, featureSet@imageSet/@camera,
  correspondenceSet@imageSet1/2 @camera1/2 must reference declared ids
  (the reference schema has two typos — imageSet2 is matched as a child
  element and camera2's field points at @camera1 (project.xsd:73-91); we
  enforce the evident intent).

Raises :class:`ProjectValidationError` with an element path.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET


class ProjectValidationError(ValueError):
    """Project file violates the project.xsd structural contract."""


def _err(path, msg):
    raise ProjectValidationError(f"{path}: {msg}")


# xsd:double lexical space (XML Schema Part 2 §3.2.5): optional sign,
# decimal mantissa, optional exponent, or the literals INF/-INF/NaN.
# Python's float() is looser ('1_0', 'infinity', leading '+nan') so it
# cannot stand in for the XSD contract.
_DOUBLE_RE = re.compile(
    r"^(?:[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?|-?INF|NaN)$")


def _is_double(v: str) -> bool:
    return isinstance(v, str) and bool(_DOUBLE_RE.match(v))


def _is_nonneg_int(v: str) -> bool:
    try:
        return int(v) >= 0
    except (TypeError, ValueError):
        return False


def _is_int(v: str) -> bool:
    try:
        int(v)
        return True
    except (TypeError, ValueError):
        return False


def _require(el, path, **checks):
    for attr, check in checks.items():
        v = el.get(attr)
        if v is None:
            _err(path, f"missing required attribute '{attr}'")
        if not check(v):
            _err(path, f"attribute '{attr}'={v!r} has invalid type")


def _optional(el, path, **checks):
    for attr, check in checks.items():
        v = el.get(attr)
        if v is not None and not check(v):
            _err(path, f"attribute '{attr}'={v!r} has invalid type")


def validate_project_xml(root: ET.Element) -> None:
    """Validate a parsed <project> tree; raises ProjectValidationError."""
    if root.tag != "project":
        _err("/", f"root element is <{root.tag}>, expected <project>")

    order = ["cameras", "imageSets", "featureSets", "correspondenceSets"]
    seen = []
    for child in root:
        if child.tag not in order:
            _err(f"/project/{child.tag}", "unexpected element")
        if child.tag in seen:
            _err(f"/project/{child.tag}", "element occurs more than once")
        if seen and order.index(child.tag) < order.index(seen[-1]):
            _err(f"/project/{child.tag}",
                 f"out of order (must follow {seen[-1]})")
        seen.append(child.tag)

    camera_ids = set()
    image_set_ids = set()

    cameras = root.find("cameras")
    if cameras is not None:
        _optional(cameras, "/project/cameras",
                  num=lambda v: _is_nonneg_int(v) and int(v) > 0)
        for cam in cameras:
            if cam.tag != "camera":
                _err(f"/project/cameras/{cam.tag}", "unexpected element")
            _require(cam, "/project/cameras/camera",
                     id=lambda v: True)
            cid = cam.get("id")
            path = f"/project/cameras/camera[@id={cid!r}]"
            if cid in camera_ids:
                _err(path, "duplicate camera id (key cameraID)")
            camera_ids.add(cid)

            n_resp = 0
            # Camera children are validated as a SET, not the xsd:sequence:
            # the reference's own writer emits <response> before
            # <refractiveInterface> (project.cpp:385-413), violating its
            # project.xsd sequence, so strict ordering would reject real
            # reference-written projects.  Element types and single
            # occurrence are still enforced.
            corder = ["projectionMatrix", "lensDistortion",
                      "refractiveInterface", "response"]
            cseen = []
            for sub in cam:
                if sub.tag not in corder:
                    _err(f"{path}/{sub.tag}", "unexpected element")
                if sub.tag != "response" and sub.tag in cseen:
                    _err(f"{path}/{sub.tag}", "occurs more than once")
                cseen.append(sub.tag)

                if sub.tag == "projectionMatrix":
                    _require(sub, f"{path}/projectionMatrix",
                             **{f"m{r}{c}": _is_double
                                for r in range(1, 4) for c in range(1, 5)})
                elif sub.tag == "lensDistortion":
                    _optional(sub, f"{path}/lensDistortion",
                              k1=_is_double, k2=_is_double, k3=_is_double,
                              p1=_is_double, p2=_is_double)
                elif sub.tag == "refractiveInterface":
                    _require(sub, f"{path}/refractiveInterface",
                             px=_is_double, py=_is_double,
                             dist=_is_double, refractiveRatio=_is_double)
                elif sub.tag == "response":
                    n_resp += 1
                    if n_resp > 3:
                        _err(f"{path}/response",
                             "more than 3 response curves")
                    ch = sub.get("channel")
                    if ch not in ("red", "green", "blue"):
                        _err(f"{path}/response",
                             f"channel={ch!r} not in red|green|blue")
                    values = sub.findall("value")
                    if len(values) < 256:
                        _err(f"{path}/response[@channel={ch!r}]",
                             f"needs >= 256 <value> elements, "
                             f"has {len(values)}")
                    for v in values:
                        if not _is_double(v.text or ""):
                            _err(f"{path}/response/value",
                                 f"non-double value {v.text!r}")

    image_sets = root.find("imageSets")
    if image_sets is not None:
        _optional(image_sets, "/project/imageSets", num=_is_nonneg_int)
        for iset in image_sets:
            if iset.tag != "imageSet":
                _err(f"/project/imageSets/{iset.tag}", "unexpected element")
            _require(iset, "/project/imageSets/imageSet",
                     id=lambda v: True)
            sid = iset.get("id")
            path = f"/project/imageSets/imageSet[@id={sid!r}]"
            if sid in image_set_ids:
                _err(path, "duplicate imageSet id (key imageSetID)")
            image_set_ids.add(sid)
            for img in iset:
                if img.tag != "image":
                    _err(f"{path}/{img.tag}", "unexpected element")
                _require(img, f"{path}/image", file=lambda v: True)
                _optional(img, f"{path}/image", exposure=_is_double)
                dflt = img.get("default")
                if dflt is not None and dflt != "yes":
                    _err(f"{path}/image",
                         f"default={dflt!r}, only 'yes' allowed")
                cam_for = img.get("for")
                if cam_for is not None and cam_for not in camera_ids:
                    _err(f"{path}/image",
                         f"for={cam_for!r} references no camera "
                         "(keyref imageToCameraRef)")

    feature_sets = root.find("featureSets")
    if feature_sets is not None:
        _optional(feature_sets, "/project/featureSets",
                  num=lambda v: _is_nonneg_int(v) and int(v) > 0)
        for fset in feature_sets:
            if fset.tag != "featureSet":
                _err(f"/project/featureSets/{fset.tag}",
                     "unexpected element")
            path = "/project/featureSets/featureSet"
            _require(fset, path, imageSet=lambda v: True,
                     camera=lambda v: True)
            if fset.get("imageSet") not in image_set_ids:
                _err(path, f"imageSet={fset.get('imageSet')!r} references "
                     "no imageSet (keyref featureSetToImageSetRef)")
            if fset.get("camera") not in camera_ids:
                _err(path, f"camera={fset.get('camera')!r} references no "
                     "camera (keyref featureSetToCameraRef)")
            indices = set()
            for f in fset:
                if f.tag != "feature":
                    _err(f"{path}/{f.tag}", "unexpected element")
                _require(f, f"{path}/feature", type=lambda v: True,
                         x=_is_double, y=_is_double,
                         index=_is_nonneg_int)
                _optional(f, f"{path}/feature", cindex=_is_int)
                idx = f.get("index")
                if idx in indices:
                    _err(f"{path}/feature",
                         f"duplicate index {idx} within featureSet")
                indices.add(idx)

    corr_sets = root.find("correspondenceSets")
    if corr_sets is not None:
        _optional(corr_sets, "/project/correspondenceSets",
                  num=lambda v: _is_nonneg_int(v) and int(v) > 0)
        for cset in corr_sets:
            if cset.tag != "correspondenceSet":
                _err(f"/project/correspondenceSets/{cset.tag}",
                     "unexpected element")
            path = "/project/correspondenceSets/correspondenceSet"
            _require(cset, path, imageSet1=lambda v: True,
                     imageSet2=lambda v: True, camera1=lambda v: True,
                     camera2=lambda v: True)
            for attr in ("imageSet1", "imageSet2"):
                if cset.get(attr) not in image_set_ids:
                    _err(path, f"{attr}={cset.get(attr)!r} references no "
                         "imageSet (keyref)")
            for attr in ("camera1", "camera2"):
                if cset.get(attr) not in camera_ids:
                    _err(path, f"{attr}={cset.get(attr)!r} references no "
                         "camera (keyref)")
            for c in cset:
                if c.tag != "correspondence":
                    _err(f"{path}/{c.tag}", "unexpected element")
                _require(c, f"{path}/correspondence",
                         index1=_is_nonneg_int, index2=_is_nonneg_int)
