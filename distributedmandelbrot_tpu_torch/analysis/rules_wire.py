"""Wire-format parity rules.

The reference system's canonical defect was the same constant typed
into three files (DataChunk.cs, worker, viewer) with nothing checking
the copies agree.  Post-dedup, this repo keeps every struct format in
exactly one place and these rules keep it that way:

``wire-literal`` — a struct format *string literal* (``struct.Struct``,
``struct.pack``/``unpack``/``unpack_from``/``pack_into``/``calcsize``)
in any module outside the canonical set.  Canonical modules:
net/protocol.py, net/framing.py, core/workload.py, storage/index.py,
serve/render.py (the PNG container), and codecs/ (each owns its own
on-disk format).  Everyone else must import the precompiled
``struct.Struct`` objects from net/protocol.py.

``wire-size`` — inside the canonical modules, every ``NAME_WIRE_SIZE =
<int>`` constant must equal ``struct.calcsize`` of the ``NAME = struct.
Struct("...")`` it describes, and the documented composition
``QUERY == u32 level + QUERY_TAIL`` must hold byte-for-byte (the
gateway reads the leading u32 alone to sniff the batch magic).

``wire-parity`` — the protocol-speaking modules must actually
reference the canonical symbols for the messages they speak (via
``proto.X`` or ``from ...net.protocol import X``); a module that stops
doing so has, by construction, re-typed the format somewhere.  Modules
absent from the project (fixture runs) are skipped.
"""

from __future__ import annotations

import ast
import struct as _struct
from typing import Optional

from distributedmandelbrot_tpu_torch.analysis.astutil import (cached_walk,
                                                        call_chain,
                                                        dotted_names)
from distributedmandelbrot_tpu_torch.analysis.engine import (PACKAGE, Finding,
                                                       Project, Rule,
                                                       SourceFile)

RULES = (
    Rule("wire-literal", "wire", "error",
         "struct format literal outside the canonical wire modules"),
    Rule("wire-size", "wire", "error",
         "wire size constant disagrees with its struct format"),
    Rule("wire-parity", "wire", "error",
         "protocol-speaking module does not use the canonical structs"),
)

PROTOCOL = f"{PACKAGE}/net/protocol.py"

CANONICAL = frozenset({
    PROTOCOL,
    f"{PACKAGE}/net/framing.py",
    f"{PACKAGE}/core/workload.py",
    f"{PACKAGE}/storage/index.py",
    # The PNG container: big-endian chunk/IHDR formats are PNG's, not
    # the dmtpu wire protocol's, and live only in the render module.
    f"{PACKAGE}/serve/render.py",
})
CANONICAL_PREFIXES = (f"{PACKAGE}/codecs/",)

STRUCT_FUNCS = frozenset({"Struct", "pack", "unpack", "unpack_from",
                          "pack_into", "calcsize", "iter_unpack"})

# module -> canonical net/protocol.py symbols it must reference.
REQUIRED_SYMBOLS = {
    f"{PACKAGE}/coordinator/dataserver.py": ("QUERY",),
    f"{PACKAGE}/coordinator/distributer.py": ("SPANS_HEADER", "SPAN_SYNC",
                                              "SPAN_RECORD"),
    f"{PACKAGE}/serve/gateway.py": ("QUERY", "QUERY_TAIL"),
    f"{PACKAGE}/viewer/client.py": ("QUERY", "BATCH_HEADER"),
    f"{PACKAGE}/worker/client.py": ("WORKLOAD_WIRE_SIZE", "SPANS_HEADER",
                                    "SPAN_SYNC", "SPAN_RECORD"),
}

# Span wire frames whose format must lead with the QUERY key triple
# (level, index_real, index_imag as 3 x u32): keyed frames share one
# prefix so a reader can always peel the key the same way.
KEYED_SPAN_STRUCTS = ("SPAN_SYNC", "SPAN_RECORD")


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for rel in sorted(project.files):
        if rel in CANONICAL or rel.startswith(CANONICAL_PREFIXES):
            findings.extend(_check_sizes(project.files[rel]))
        else:
            findings.extend(_check_literals(project.files[rel]))
    for rel, symbols in REQUIRED_SYMBOLS.items():
        sf = project.file(rel)
        if sf is not None:
            findings.extend(_check_parity(sf, symbols))
    return findings


# -- wire-literal -----------------------------------------------------------

def _format_literal(call: ast.Call) -> Optional[str]:
    chain = call_chain(call)
    if not chain or chain[0] != "struct" or chain[-1] not in STRUCT_FUNCS:
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _check_literals(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for node in cached_walk(sf.tree):
        if isinstance(node, ast.Call):
            fmt = _format_literal(node)
            if fmt is not None:
                out.append(Finding(
                    "wire-literal", "error", sf.relpath, node.lineno,
                    f'struct format "{fmt}" re-typed outside the canonical '
                    f'wire modules (import the precompiled Struct from '
                    f'net/protocol.py)'))
    return out


# -- wire-size --------------------------------------------------------------

def _module_constants(sf: SourceFile) -> tuple[dict[str, str], dict[str, int]]:
    """Top-level ``NAME = struct.Struct("fmt")`` and ``NAME = <int>``."""
    fmts: dict[str, str] = {}
    ints: dict[str, int] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            name, value = node.target.id, node.value
        else:
            continue
        if isinstance(value, ast.Call):
            fmt = _format_literal(value)
            if fmt is not None and call_chain(value) == ["struct", "Struct"]:
                fmts[name] = fmt
        elif isinstance(value, ast.Constant) and isinstance(value.value, int) \
                and not isinstance(value.value, bool):
            ints[name] = value.value
    return fmts, ints


def _calcsize(fmt: str) -> Optional[int]:
    try:
        return _struct.calcsize(fmt)
    except _struct.error:
        return None


def _check_sizes(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    fmts, ints = _module_constants(sf)
    for name, fmt in fmts.items():
        size_name = f"{name}_WIRE_SIZE"
        declared = ints.get(size_name)
        if declared is None:
            continue
        actual = _calcsize(fmt)
        if actual is None:
            out.append(Finding(
                "wire-size", "error", sf.relpath, 1,
                f'{name}: invalid struct format "{fmt}"'))
        elif actual != declared:
            out.append(Finding(
                "wire-size", "error", sf.relpath, 1,
                f'{size_name} = {declared} but struct.calcsize("{fmt}") '
                f'= {actual}'))
    if sf.relpath == PROTOCOL and "QUERY" in fmts and "QUERY_TAIL" in fmts:
        head, tail = fmts["QUERY"], fmts["QUERY_TAIL"]
        if head != "<I" + tail.lstrip("<"):
            out.append(Finding(
                "wire-size", "error", sf.relpath, 1,
                f'QUERY ("{head}") must be a leading u32 followed '
                f'byte-for-byte by QUERY_TAIL ("{tail}"): the gateway '
                f'sniffs the first u32 for the batch magic'))
    if sf.relpath == PROTOCOL:
        key_prefix = fmts.get("QUERY", "<III")
        for name in KEYED_SPAN_STRUCTS:
            fmt = fmts.get(name)
            if fmt is not None and not fmt.startswith(key_prefix):
                out.append(Finding(
                    "wire-size", "error", sf.relpath, 1,
                    f'{name} ("{fmt}") must lead with the QUERY key '
                    f'triple ("{key_prefix}"): keyed frames share the '
                    f'tile-key prefix'))
    return out


# -- wire-parity ------------------------------------------------------------

def _protocol_refs(sf: SourceFile) -> set[str]:
    """Protocol symbols this module references: names imported from
    net.protocol, plus ``<alias>.NAME`` for any alias of the module."""
    aliases: set[str] = set()
    imported: set[str] = set()
    for node in cached_walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.endswith("net.protocol"):
                imported.update(a.asname or a.name for a in node.names)
            elif node.module.endswith(".net"):
                for a in node.names:
                    if a.name == "protocol":
                        aliases.add(a.asname or "protocol")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("net.protocol"):
                    aliases.add(a.asname or a.name)
    refs = set(imported)
    if aliases:
        for dotted in dotted_names(sf.tree):
            head, _, last = dotted.rpartition(".")
            if head in aliases:
                refs.add(last)
    return refs


def _check_parity(sf: SourceFile, symbols: tuple[str, ...]) -> list[Finding]:
    refs = _protocol_refs(sf)
    return [Finding(
        "wire-parity", "error", sf.relpath, 1,
        f"module speaks the {sym} message but never references "
        f"net/protocol.py's canonical {sym} (re-typed format?)")
        for sym in symbols if sym not in refs]
