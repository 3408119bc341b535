"""Transects: output along polylines.

Re-design of src/UFEMISM/transects/transects_main.f90: transects are
specified in the config as 'name,dx=5e3' (hardcoded waypoint sets,
:194-260) or 'file:waypoints.cfg,dx=2e3', resampled to equidistant
vertices, sampled through precomputed barycentric weights (host-side
scipy), and written to their own NetCDF files with along- and
across-transect velocities and grounding-line and calving-front positions
(:700-790): the variables the reference's integrated-test analyses read
(u_ort_3D, grounding_line_distance_from_start). Each output event reads
the state to the host once.
"""

from __future__ import annotations

import numpy as np

from ..remap.conservative import build_map_trilin_mesh_to_points


# Antarctic flowline/grounding-line waypoint sets: coordinate DATA
# transcribed from the reference (transects_main.f90:312-480),
# exactly like mesh/roi_polygons.py's catchment outlines.
_ANT_WAYPOINTS = {
    "PineIsland_centralflowline": [
        (-1581444.261355978, -30311.971888969),
        (-1582246.435803775, -35247.204016772),
        (-1582303.29234495, -40246.880739694),
        (-1582185.249855441, -45245.48714255),
        (-1582081.544495048, -50244.411546682),
        (-1582662.969743382, -55210.490954081),
        (-1583493.442845907, -60141.040053926),
        (-1584240.740762885, -65084.879232468),
        (-1584851.396852385, -70047.449044607),
        (-1585308.445570337, -75026.515871777),
        (-1585578.82126354, -80019.20021835),
        (-1585586.411846643, -85019.194456652),
        (-1585392.585848335, -90015.436192435),
        (-1585000.0, -95000.0),
        (-1584607.414151665, -99984.563807565),
        (-1584178.880875366, -104966.16588231),
        (-1583919.19417227, -109959.417610016),
        (-1583954.223315052, -114959.294904426),
        (-1584220.471737793, -119952.201049887),
        (-1584610.216958133, -124936.987771827),
        (-1585093.965814203, -129913.531456378),
        (-1585561.266089043, -134891.646607029),
        (-1585996.797933316, -139872.641689602),
        (-1586344.192008271, -144860.558825711),
        (-1586579.82985823, -149855.003219602),
        (-1586688.774455813, -154853.816186163),
        (-1586720.851753739, -159853.7132898),
        (-1586818.829539264, -164852.753232983),
        (-1586978.885063885, -169850.19079928),
        (-1587219.321903611, -174844.406466039),
        (-1587355.55603375, -179842.550147626),
        (-1587304.596740988, -184842.29045593),
        (-1587008.84589727, -189833.535935612),
        (-1586313.384448024, -194784.933048813),
        (-1585415.1368918, -199703.58645475),
        (-1584571.422291555, -204631.886940042),
        (-1583927.625182513, -209590.266240014),
        (-1583556.350183616, -214576.462673689),
        (-1583458.692634559, -219575.508883028),
        (-1583673.903094605, -224570.875181698),
        (-1584160.056601684, -229547.184533774),
        (-1584950.493050585, -234484.310238093),
        (-1586093.394698516, -239351.935513642),
        (-1588274.448157067, -243851.158314408),
        (-1590063.024692466, -248520.311768411),
        (-1591964.534323602, -253144.623730497),
        (-1593581.60629759, -257875.910894784),
        (-1594960.641571018, -262681.97599158),
        (-1596396.222333623, -267471.454864489),
        (-1597877.923431084, -272246.867083112),
        (-1599403.797726561, -277008.348746881),
        (-1600961.6671348, -281759.458396939),
        (-1602563.990685723, -286495.760671726),
        (-1604227.207405997, -291211.024200035),
        (-1605962.531725658, -295900.229836984),
        (-1607790.896495252, -300553.946874934),
        (-1609721.065547457, -305166.370037428),
        (-1611801.062234093, -309713.194619879),
        (-1613991.890870033, -314207.665655268),
        (-1616297.252580522, -318644.47840586),
        (-1618714.397099108, -323021.396542662),
        (-1621028.944400364, -327453.424384434),
        (-1623343.49170162, -331885.452226207),
        (-1625658.039002877, -336317.48006798),
        (-1627972.586304133, -340749.507909753),
        (-1630287.133605389, -345181.535751525),
        (-1632601.680906645, -349613.563593298),
        (-1634916.228207901, -354045.591435071),
        (-1637230.775509157, -358477.619276843),
        (-1639545.322810413, -362909.647118616),
        (-1641859.870111669, -367341.674960389),
        (-1644174.417412925, -371773.702802161),
    ],
    "PineIsland_groundingline": [
        (-1605000.0, -245000.0),
        (-1570000.0, -255000.0),
    ],
    "Thwaites_centralflowline": [
        (-1262096.857411107, -438496.332811367),
        (-1267094.568089579, -438647.620531574),
        (-1272062.926853136, -439209.235343157),
        (-1277000.0, -440000.0),
        (-1281937.073146864, -440790.764656843),
        (-1286846.151547105, -441739.948127141),
        (-1291762.313729901, -442651.731759614),
        (-1296616.07715123, -443852.140294145),
        (-1301417.963270147, -445245.657319859),
        (-1306169.781465008, -446801.364182665),
        (-1310844.962489247, -448574.125416052),
        (-1315510.104371187, -450373.139374133),
        (-1320269.834067099, -451904.469913843),
        (-1325202.382474215, -452722.984551133),
        (-1330202.374209151, -452732.075787285),
        (-1335194.857178497, -452458.006816433),
        (-1340194.796803991, -452433.435666387),
        (-1345194.083700367, -452517.878118564),
        (-1350194.047295371, -452536.958176968),
        (-1355193.800248603, -452586.661362422),
        (-1360193.80023782, -452586.332983246),
        (-1365191.611720165, -452734.253187886),
        (-1370173.725508693, -453156.79572795),
        (-1375094.914783623, -454041.044629737),
        (-1380042.523096452, -454762.967051344),
        (-1384985.030458033, -455519.023253439),
        (-1389905.381954831, -456407.922093552),
        (-1394758.062859852, -457612.699265498),
        (-1399549.605770857, -459041.375762121),
        (-1404412.006691101, -460206.303781702),
        (-1409375.125235378, -460812.483883206),
        (-1414363.677683855, -461150.632473021),
        (-1419348.305049395, -461542.410505466),
        (-1424325.029013987, -462024.301136476),
        (-1429276.934310823, -462716.1348818),
        (-1434182.109406869, -463685.287747517),
        (-1439019.008423905, -464951.939988269),
        (-1443849.185719868, -466243.987700066),
        (-1448726.93169515, -467342.893610787),
        (-1453607.812480557, -468427.791190582),
        (-1458543.806615878, -469225.263381994),
        (-1463442.227989308, -470227.993678896),
        (-1468340.985966536, -471229.078231043),
        (-1473300.063257687, -471867.476555276),
        (-1478267.381997524, -471296.736214254),
        (-1483195.430158483, -470451.549061452),
        (-1488155.780636239, -469823.119958193),
        (-1493126.229684642, -469280.315889273),
        (-1498125.332401152, -469185.595090182),
        (-1503125.181982443, -469224.378649324),
        (-1508124.245996874, -469321.12046873),
        (-1513110.99640437, -468957.361794142),
        (-1518025.699462808, -468037.745652817),
        (-1522926.373830334, -467046.085053888),
        (-1527888.330802762, -466430.469099107),
        (-1532887.623379006, -466514.574610874),
        (-1537747.238844029, -467691.06835591),
        (-1542254.522273829, -469855.414927846),
        (-1546644.235647556, -472249.243763942),
        (-1551060.793902853, -474593.17490149),
        (-1555454.997509384, -476978.751281392),
        (-1559828.912059237, -479401.326669401),
        (-1564088.885569191, -482019.07870015),
        (-1568262.0541336, -484773.105594177),
        (-1572310.964033627, -487706.760076468),
        (-1576326.4333544, -490686.022759403),
        (-1580341.902675174, -493665.285442338),
        (-1584357.371995947, -496644.548125273),
        (-1588372.84131672, -499623.810808208),
        (-1592388.310637493, -502603.073491143),
        (-1596403.779958266, -505582.336174078),
        (-1600419.249279039, -508561.598857013),
        (-1604434.718599813, -511540.861539948),
        (-1608450.187920586, -514520.124222883),
        (-1612465.657241359, -517499.386905818),
        (-1616481.126562132, -520478.649588753),
    ],
    "Thwaites_groundingline": [
        (-1520000.0, -400000.0),
        (-1495000.0, -510000.0),
    ],
}


def hardcoded_waypoints(mesh, name: str) -> np.ndarray:
    """The reference's native transect waypoint sets
    (transects_main.f90:194-260)."""
    x0, x1 = mesh.xmin, mesh.xmax
    y0, y1 = mesh.ymin, mesh.ymax
    table = {
        "east": [(0, 0), (x1, 0)],
        "west": [(0, 0), (x0, 0)],
        "south": [(0, 0), (0, y0)],
        "north": [(0, 0), (0, y1)],
        "northeast": [(0, 0), (x1, y1)],
        "southeast": [(0, 0), (x1, y0)],
        "northwest": [(0, 0), (x0, y1)],
        "southwest": [(0, 0), (x0, y0)],
        "westeast": [(x0, 0), (x1, 0)],
        "southnorth": [(0, y0), (0, y1)],
        "ISMIP-HOM": [(x0 / 2, y0 / 4), (x1 / 2, y0 / 4)],
    }
    if name in _ANT_WAYPOINTS:
        return np.asarray(_ANT_WAYPOINTS[name], dtype=np.float64)
    if name not in table:
        raise ValueError(f"unknown native transect option '{name}'")
    return np.asarray(table[name], dtype=np.float64)


def parse_transect_str(s: str):
    """'name,dx=5e3' or 'file:path.cfg,dx=2e3' -> (source, name, filename,
    dx) (parse_transect_str :131-178)."""
    i = s.find(",dx=")
    if i < 0:
        raise ValueError(f"invalid transect string '{s}': no dx")
    name = s[:i]
    dx = float(s[i + 4:])
    if name.startswith("file:"):
        fname = name[5:]
        base = fname.rsplit("/", 1)[-1]
        return "read_from_file", base.rsplit(".", 1)[0], fname, dx
    return "hardcoded", name, "", dx


def resample_waypoints(waypoints: np.ndarray, dx: float) -> np.ndarray:
    """Equidistant vertices along the waypoint polyline
    (calc_transect_vertices_from_waypoints)."""
    seg = np.diff(waypoints, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    s_way = np.concatenate([[0.0], np.cumsum(seg_len)])
    n = max(2, int(np.ceil(s_way[-1] / dx)) + 1)
    s = np.linspace(0.0, s_way[-1], n)
    x = np.interp(s, s_way, waypoints[:, 0])
    y = np.interp(s, s_way, waypoints[:, 1])
    return np.stack([x, y], axis=1)


class Transect:
    """A resampled polyline on one mesh: along-transect distance, unit
    tangents and normals, the vertex-to-point map and the nearest
    triangle of each point."""

    def __init__(self, mesh, points: np.ndarray, name: str = "transect"):
        self.name = name
        self.points = np.asarray(points)
        d = np.diff(self.points, axis=0)
        self.s = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
        # unit tangent (along-transect) per vertex; the normal is the
        # tangent rotated by -90 degrees (across-transect, the reference's
        # u_ort)
        t = np.vstack([d, d[-1:]])
        t = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-300)
        self.tangent = t
        self.normal = np.stack([t[:, 1], -t[:, 0]], axis=1)
        self.M_vertices = build_map_trilin_mesh_to_points(mesh, self.points)
        from scipy.spatial import cKDTree
        _, self.tri_idx = cKDTree(mesh.TriGC).query(self.points)
        self.zeta = mesh.zeta

    @classmethod
    def from_config_str(cls, mesh, transect_str: str):
        source, name, fname, dx = parse_transect_str(transect_str)
        if source == "hardcoded":
            wp = hardcoded_waypoints(mesh, name)
        else:
            wp = np.loadtxt(fname, comments=("!", "#", "&", "/"))
            wp = np.atleast_2d(wp)[:, :2]
        return cls(mesh, resample_waypoints(wp, dx), name)

    @classmethod
    def named(cls, mesh, name: str, dx: float = 5e3):
        return cls(mesh, resample_waypoints(
            hardcoded_waypoints(mesh, name), dx), name)

    def sample_vertices(self, field):
        """An a-grid field ([nV] or [nV, k], on the host) along the
        transect."""
        return self.M_vertices @ np.asarray(field)

    def sample_triangles(self, field):
        """A b-grid field along the transect (nearest triangle)."""
        return np.asarray(field)[self.tri_idx]

    def velocity_components(self, u_3D_b, v_3D_b):
        """(u_par_3D, u_ort_3D): along- and across-transect velocity
        [n, nz] (calc_velocity_weights :600-640)."""
        u = self.sample_triangles(u_3D_b)
        v = self.sample_triangles(v_3D_b)
        u_par = u * self.tangent[:, 0:1] + v * self.tangent[:, 1:2]
        u_ort = u * self.normal[:, 0:1] + v * self.normal[:, 1:2]
        return u_par, u_ort

    def zero_crossing_distance(self, f, from_end=False):
        """Distance along the transect to the first sign change of f
        (positive to non-positive), linearly interpolated; NaN if none.
        The grounding line (f = TAF) and calving front (f = Hi - 0.1)."""
        f = np.asarray(f)
        s = self.s
        if from_end:
            f = f[::-1]
            s = s[-1] - s[::-1]
        ix = np.flatnonzero((f[:-1] > 0) & (f[1:] <= 0))
        if len(ix) == 0:
            return float("nan")
        i = ix[0]
        lam = f[i] / (f[i] - f[i + 1])
        return float((1 - lam) * s[i] + lam * s[i + 1])


class TransectOutputFile:
    """transect_<name>.nc with the reference's variable set
    (create_transect_netcdf_output_file :700-790), a NetCDF classic file
    rewritten whole at every write (io/ncio.py)."""

    def __init__(self, path, transect: Transect):
        from ..io.ncio import NCFile
        self.tr = transect
        self.nc = NCFile(path, "w")
        n = len(transect.points)
        nz = len(transect.zeta)
        self.nc.def_dim("time", None)
        self.nc.def_dim("n", n)
        self.nc.def_dim("two", 2)
        self.nc.def_dim("zeta", nz)
        self.nc.def_var("zeta", ("zeta",))
        self.nc.put("zeta", transect.zeta)
        self.nc.def_var("V", ("n", "two"), units="m")
        self.nc.put("V", transect.points)
        self.nc.def_var("s", ("n",), units="m")
        self.nc.put("s", transect.s)
        self.nc.def_var("time", ("time",), units="years")
        for f in ("Hi", "Hb", "Hs", "Hib", "SL", "TAF"):
            self.nc.def_var(f, ("time", "n"), units="m")
        for f in ("u_par_3D", "u_ort_3D"):
            self.nc.def_var(f, ("time", "n", "zeta"), units="m yr^-1")
        for f in ("grounding_line_distance_from_start",
                  "grounding_line_distance_from_end",
                  "calving_front_distance_from_start",
                  "calving_front_distance_from_end",
                  "ice_mass_flux"):
            self.nc.def_var(f, ("time",))
        self.nc.flush()

    def write(self, time, state):
        """Append one timeframe sampled from the state (one host read)."""
        from ..core.fields import host_arrays
        from ..utils.constants import ice_density
        tr = self.tr
        h = host_arrays({k: getattr(state, k) for k in (
            "Hi", "Hb", "Hs", "Hib", "SL", "TAF", "u_3D_b", "v_3D_b")})
        first = True
        for name in ("Hi", "Hb", "Hs", "Hib", "SL", "TAF"):
            self.nc.append(name, tr.sample_vertices(h[name]),
                           coord=time if first else None)
            first = False
        u_par, u_ort = tr.velocity_components(h["u_3D_b"], h["v_3D_b"])
        self.nc.append("u_par_3D", u_par)
        self.nc.append("u_ort_3D", u_ort)
        taf_t = tr.sample_vertices(h["TAF"])
        hi_t = tr.sample_vertices(h["Hi"])
        self.nc.append("grounding_line_distance_from_start",
                       tr.zero_crossing_distance(taf_t))
        self.nc.append("grounding_line_distance_from_end",
                       tr.zero_crossing_distance(taf_t, from_end=True))
        self.nc.append("calving_front_distance_from_start",
                       tr.zero_crossing_distance(hi_t - 0.1))
        self.nc.append("calving_front_distance_from_end",
                       tr.zero_crossing_distance(hi_t - 0.1,
                                                 from_end=True))
        # vertically averaged mass flux across the transect [kg/yr]:
        # trapezoidal over zeta, so an irregular vertical grid is weighted
        # by layer thickness
        u_vav_ort = np.trapezoid(u_ort, np.asarray(tr.zeta), axis=1)
        ds = np.gradient(tr.s)
        self.nc.append("ice_mass_flux",
                       float((u_vav_ort * hi_t * ds).sum() * ice_density))
        self.nc.flush()

    def close(self):
        self.nc.close()
