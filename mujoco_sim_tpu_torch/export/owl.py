"""OWL knowledge-graph exporters (self-contained RDF/XML, no owlready2).

Equivalents of the reference's ontology pipeline (SURVEY §2.3):
- usd_to_abox:  USD stage -> OWL ABox individuals (script/usd_to_ABox.py)
- tbox_to_usd:  ontology class hierarchy -> USD class prims
                (script/TBox_to_usd.py:31-95)
- update_joint_states: live joint states -> hasJointValue rewrites
                (script/mujoco_to_ABox.py:25-56)
- auto_sem_tag: link ABox individuals to TBox classes
                (model/ontology/script/auto_sem_tag.py:16-36)
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

_RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
_OWL = "http://www.w3.org/2002/07/owl#"
_RDFS = "http://www.w3.org/2000/01/rdf-schema#"
_XSD = "http://www.w3.org/2001/XMLSchema#"

ET.register_namespace("rdf", _RDF)
ET.register_namespace("owl", _OWL)
ET.register_namespace("rdfs", _RDFS)


def _rdf_root(base: str) -> ET.Element:
    root = ET.Element(f"{{{_RDF}}}RDF", {"xml:base": base})
    ont = ET.SubElement(root, f"{{{_OWL}}}Ontology",
                        {f"{{{_RDF}}}about": base})
    return root


def usd_to_abox(usda_path: str, owl_path: str,
                base: str = "http://mujoco_sim_tpu/scene.owl") -> str:
    """Parse a (text) USD stage and emit one OWL individual per prim with
    its type, pose and mass as data properties."""
    with open(usda_path) as f:
        text = f.read()
    root = _rdf_root(base)
    prim_re = re.compile(r'def (\w+) "([^"]+)"')
    # walk prims with their translate/mass attributes (flat scan per block)
    blocks = []
    stack = []
    for lineno, line in enumerate(text.splitlines()):
        mo = prim_re.search(line)
        if mo:
            blocks.append((mo.group(1), mo.group(2), lineno))
    for kind, name, lineno in blocks:
        ind = ET.SubElement(root, f"{{{_OWL}}}NamedIndividual",
                            {f"{{{_RDF}}}about": f"{base}#{name}"})
        t = ET.SubElement(ind, f"{{{_RDF}}}type",
                          {f"{{{_RDF}}}resource": f"{base}#{kind}"})
        # find the first translate after the def within ~40 lines
        seg = "\n".join(text.splitlines()[lineno:lineno + 40])
        mt = re.search(r"xformOp:translate = \(([^)]+)\)", seg)
        if mt:
            prop = ET.SubElement(
                ind, f"{{{_RDF}}}hasTranslation",
                {f"{{{_RDF}}}datatype": f"{_XSD}string"})
            prop.text = mt.group(1)
        mm = re.search(r"physics:mass = ([0-9.eE+-]+)", seg)
        if mm:
            prop = ET.SubElement(
                ind, f"{{{_RDF}}}hasMass",
                {f"{{{_RDF}}}datatype": f"{_XSD}double"})
            prop.text = mm.group(1)
    ET.indent(root)
    ET.ElementTree(root).write(owl_path, xml_declaration=True,
                               encoding="unicode")
    return owl_path


def parse_tbox_classes(owl_path: str) -> dict[str, str | None]:
    """OWL TBox -> {class_name: parent_class_name}."""
    tree = ET.parse(owl_path)
    classes = {}
    for cls in tree.getroot().iter(f"{{{_OWL}}}Class"):
        about = cls.get(f"{{{_RDF}}}about", "")
        name = about.split("#")[-1].split("/")[-1]
        if not name:
            continue
        parent = None
        sub = cls.find(f"{{{_RDFS}}}subClassOf")
        if sub is not None:
            pref = sub.get(f"{{{_RDF}}}resource", "")
            parent = pref.split("#")[-1].split("/")[-1] or None
        classes[name] = parent
    return classes


def tbox_to_usd(owl_path: str, usda_path: str) -> str:
    """Ontology class hierarchy -> USD class prims with an RdfAPI-style
    attribute carrying the IRI (TBox_to_usd.py:31-95)."""
    classes = parse_tbox_classes(owl_path)
    lines = ["#usda 1.0", "(", '    defaultPrim = "TBox"', ")", "",
             'def Scope "TBox"', "{"]
    # emit parents before children
    emitted = set()

    def emit(name, indent="    "):
        if name in emitted or name is None:
            return
        parent = classes.get(name)
        if parent and parent not in emitted and parent in classes:
            emit(parent, indent)
        safe = re.sub(r"\W", "_", name)
        inherit = ""
        if parent and parent in classes:
            psafe = re.sub(r"\W", "_", parent)
            inherit = f" (\n{indent}    inherits = </TBox/{psafe}>\n{indent})"
        lines.append(f'{indent}class "{safe}"{inherit}')
        lines.append(indent + "{")
        lines.append(f'{indent}    string rdf:iri = "{name}"')
        lines.append(indent + "}")
        emitted.add(name)

    for name in classes:
        emit(name)
    lines.append("}")
    with open(usda_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return usda_path


def update_joint_states(owl_path: str, joint_values: dict[str, float],
                        out_path: str | None = None) -> str:
    """Rewrite hasJointValue data properties for named joints
    (mujoco_to_ABox.py:25-56 live updater)."""
    tree = ET.parse(owl_path)
    root = tree.getroot()
    ns_ind = f"{{{_OWL}}}NamedIndividual"
    for ind in root.iter(ns_ind):
        about = ind.get(f"{{{_RDF}}}about", "")
        name = about.split("#")[-1]
        if name in joint_values:
            found = False
            for child in ind:
                if child.tag.endswith("hasJointValue"):
                    child.text = repr(float(joint_values[name]))
                    found = True
            if not found:
                prop = ET.SubElement(
                    ind, f"{{{_RDF}}}hasJointValue",
                    {f"{{{_RDF}}}datatype": f"{_XSD}double"})
                prop.text = repr(float(joint_values[name]))
    out = out_path or owl_path
    ET.indent(root)
    tree.write(out, xml_declaration=True, encoding="unicode")
    return out


def auto_sem_tag(abox_path: str, tbox_path: str, out_path: str,
                 name_to_class: dict[str, str] | None = None) -> str:
    """Attach semanticTag references linking ABox individuals to TBox
    classes by name match (auto_sem_tag.py:16-36)."""
    classes = parse_tbox_classes(tbox_path)
    tree = ET.parse(abox_path)
    root = tree.getroot()
    for ind in root.iter(f"{{{_OWL}}}NamedIndividual"):
        about = ind.get(f"{{{_RDF}}}about", "")
        name = about.split("#")[-1]
        cls = (name_to_class or {}).get(name)
        if cls is None:
            for c in classes:
                if c.lower() in name.lower():
                    cls = c
                    break
        if cls:
            ET.SubElement(ind, f"{{{_RDF}}}semanticTag",
                          {f"{{{_RDF}}}resource": f"#{cls}"})
    ET.indent(root)
    tree.write(out_path, xml_declaration=True, encoding="unicode")
    return out_path
