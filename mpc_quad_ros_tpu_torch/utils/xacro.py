"""Minimal xacro property reader for quadrotor parameter files.

Counterpart of ``mpc_quad_ros_tpu/utils/xacro.py`` (numpy-free, jax-free):
the ``<xacro:property name=... value=...>`` entries and the ``<inertia>``
blocks of a RotorS-style description, by a real XML parse.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET


def parse_xacro_properties(path: str) -> dict:
    """{property name: value string}, plus 'body_inertia': the attribute
    dicts of every <inertia> element, in document order."""
    with open(path) as f:
        text = f.read()
    # ElementTree refuses the unbound `xacro:` prefix: drop the namespace
    # declaration and rename the prefixed tags
    text = re.sub(r"xmlns:xacro=\"[^\"]*\"", "", text, count=1)
    text = re.sub(r"<(/?)xacro:", r"<\1xacro_", text)
    root = ET.fromstring(text)

    attrib: dict = {}
    for el in root.iter():
        tag = el.tag.split("}")[-1]
        if tag in ("property", "xacro_property") and "name" in el.attrib and "value" in el.attrib:
            attrib[el.attrib["name"]] = el.attrib["value"]
        elif tag == "inertia":
            attrib.setdefault("body_inertia", []).append(dict(el.attrib))
    return attrib
