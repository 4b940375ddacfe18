"""Geospatial primitives over WKT (reference: pkg/geo — WKT/WKB types,
overlay predicates, geohash). Redesign for this engine's execution
model: geometries travel as WKT strings (varchar), and the ST_*
functions evaluate at the DICTIONARY level like every other string
function (O(distinct geometries) host work, device gathers) — planar
(cartesian) semantics.

Covered: POINT / LINESTRING / POLYGON (outer ring) parsing,
ST_GeomFromText (normalize/validate), ST_X/ST_Y, ST_Distance
(point-to-point / point-to-segment / segment-to-segment minimum),
ST_Within / ST_Contains (point-in-polygon, ray casting; polygon
containment via all-vertices + no-edge-crossing), ST_Area (shoelace),
ST_GeoHash (standard base32 geohash of a point, lon/lat order).

The port's copy of `matrixone_tpu/geo.py` (pure Python).
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

Coords = List[Tuple[float, float]]

_NUM = r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"
_PAIR_RE = re.compile(rf"({_NUM})\s+({_NUM})")


class Geometry:
    def __init__(self, kind: str, coords: Coords):
        self.kind = kind            # POINT | LINESTRING | POLYGON
        self.coords = coords        # polygon: closed outer ring

    def wkt(self) -> str:
        # repr: shortest round-trip formatting — %g's 6 significant
        # digits would shift real-world coordinates by ~30m
        pts = ", ".join(f"{x!r} {y!r}" for x, y in self.coords)
        if self.kind == "POINT":
            return f"POINT({pts})"
        if self.kind == "LINESTRING":
            return f"LINESTRING({pts})"
        return f"POLYGON(({pts}))"


def parse_wkt(text: str) -> Optional[Geometry]:
    """WKT subset parser; None for anything malformed (SQL NULL)."""
    if not isinstance(text, str):
        return None
    s = text.strip().upper()
    m = re.match(r"^(POINT|LINESTRING|POLYGON)\s*\((.*)\)$", s,
                 re.DOTALL)
    if not m:
        return None
    kind, body = m.group(1), m.group(2).strip()
    if kind == "POLYGON":
        if not (body.startswith("(") and body.endswith(")")):
            return None
        body = body[1:-1]
        if ")" in body or "(" in body:
            return None        # interior rings unsupported (v1)
    coords = [(float(a), float(b)) for a, b in _PAIR_RE.findall(body)]
    if kind == "POINT" and len(coords) != 1:
        return None
    if kind == "LINESTRING" and len(coords) < 2:
        return None
    if kind == "POLYGON":
        if len(coords) < 4 or coords[0] != coords[-1]:
            return None
    return Geometry(kind, coords)


# ------------------------------------------------------------ measures
def _seg_point_d2(p, a, b) -> float:
    ax, ay = a
    bx, by = b
    px, py = p
    dx, dy = bx - ax, by - ay
    ll = dx * dx + dy * dy
    if ll == 0:
        return (px - ax) ** 2 + (py - ay) ** 2
    t = max(0.0, min(1.0, ((px - ax) * dx + (py - ay) * dy) / ll))
    cx, cy = ax + t * dx, ay + t * dy
    return (px - cx) ** 2 + (py - cy) ** 2


def _segs(g: Geometry):
    return list(zip(g.coords[:-1], g.coords[1:]))


def _segs_cross(a1, a2, b1, b2) -> bool:
    def orient(p, q, r):
        v = (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)
    o1, o2 = orient(a1, a2, b1), orient(a1, a2, b2)
    o3, o4 = orient(b1, b2, a1), orient(b1, b2, a2)
    return o1 != o2 and o3 != o4 and 0 not in (o1, o2, o3, o4)


def distance(g1: Geometry, g2: Geometry) -> float:
    """Minimum planar distance between the two geometries' boundaries/
    points (0 when a point lies inside a polygon)."""
    if g1.kind != "POINT" and g2.kind == "POINT":
        return distance(g2, g1)
    if g1.kind == "POINT" and g2.kind == "POINT":
        (x1, y1), (x2, y2) = g1.coords[0], g2.coords[0]
        return math.hypot(x2 - x1, y2 - y1)
    if g1.kind == "POINT":
        if g2.kind == "POLYGON" and contains(g2, g1):
            return 0.0
        p = g1.coords[0]
        return math.sqrt(min(_seg_point_d2(p, a, b)
                             for a, b in _segs(g2)))
    # line/polygon vs line/polygon: min over segment pairs (+ endpoint
    # containment for polygons)
    for g, other in ((g1, g2), (g2, g1)):
        if g.kind == "POLYGON" and \
                contains(g, Geometry("POINT", [other.coords[0]])):
            return 0.0
    best = math.inf
    for a1, a2 in _segs(g1):
        for b1, b2 in _segs(g2):
            if _segs_cross(a1, a2, b1, b2):
                return 0.0
            best = min(best,
                       _seg_point_d2(a1, b1, b2), _seg_point_d2(a2, b1, b2),
                       _seg_point_d2(b1, a1, a2), _seg_point_d2(b2, a1, a2))
    return math.sqrt(best)


def area(g: Geometry) -> float:
    if g.kind != "POLYGON":
        return 0.0
    s = 0.0
    for (x1, y1), (x2, y2) in _segs(g):
        s += x1 * y2 - x2 * y1
    return abs(s) / 2.0


def _point_in_polygon(p, ring: Coords) -> bool:
    """Ray casting; boundary points count as inside (MySQL ST_Within
    on the boundary is a gray zone — we choose closed semantics)."""
    x, y = p
    for a, b in zip(ring[:-1], ring[1:]):
        if _seg_point_d2((x, y), a, b) < 1e-18:
            return True
    inside = False
    j = len(ring) - 2
    for i in range(len(ring) - 1):
        xi, yi = ring[i]
        xj, yj = ring[j]
        if (yi > y) != (yj > y) and \
                x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


def contains(outer: Geometry, inner: Geometry) -> bool:
    """outer CONTAINS inner (planar). Polygon outer only."""
    if outer.kind != "POLYGON":
        return False
    if not all(_point_in_polygon(p, outer.coords)
               for p in inner.coords):
        return False
    if inner.kind == "POINT":
        return True
    # every vertex inside and no edge escapes through the boundary
    for a1, a2 in _segs(inner):
        for b1, b2 in _segs(outer):
            if _segs_cross(a1, a2, b1, b2):
                return False
    return True


_GH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash(lon: float, lat: float, precision: int = 12) -> str:
    """Standard geohash (interleaved lon/lat bits, base32)."""
    lat_r = [-90.0, 90.0]
    lon_r = [-180.0, 180.0]
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon >= mid:
                ch = (ch << 1) | 1
                lon_r[0] = mid
            else:
                ch <<= 1
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_r[0] = mid
            else:
                ch <<= 1
                lat_r[1] = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_GH32[ch])
            bit = 0
            ch = 0
    return "".join(out)
