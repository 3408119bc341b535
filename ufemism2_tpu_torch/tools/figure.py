"""Multi-panel 2-D figures of mesh output (upsy figure.py re-design).

Field panels (a-grid gouraud / b-grid flat tripcolor) with per-variable
default colormaps and scales, difference panels between two timeframes
or two runs, and line overlays for the grounding line / calving front /
coastline / ice margin extracted as actual contour polylines (upsy
mesh.py get_gl + figure.make add_gl)."""

from __future__ import annotations

import numpy as np

from .run import MeshOutput

# per-variable plotting defaults (upsy figure.py Field.get_cmap's
# cmocean table, mapped onto matplotlib-builtin colormaps)
FIELD_DEFAULTS = {
    "Hi": dict(cmap="viridis", vmin=0),
    "Hs": dict(cmap="terrain"),
    "Hb": dict(cmap="gist_earth"),
    "Hib": dict(cmap="cividis"),
    "dHi_dt": dict(cmap="RdBu_r", center=0),
    "dHi": dict(cmap="RdBu_r", center=0),
    "divQ": dict(cmap="RdBu_r", center=0),
    "u_surf": dict(cmap="RdBu_r", center=0),
    "v_surf": dict(cmap="RdBu_r", center=0),
    "uabs_surf": dict(cmap="magma", vmin=0, log=True),
    "uabs_vav": dict(cmap="magma", vmin=0, log=True),
    "uabs_vav_b": dict(cmap="magma", vmin=0, log=True),
    "uabs_base": dict(cmap="magma", vmin=0, log=True),
    "BMB": dict(cmap="RdBu", center=0),
    "SMB": dict(cmap="RdBu", center=0),
    "fraction_gr": dict(cmap="Blues_r", vmin=0, vmax=1),
    "Ti_base": dict(cmap="plasma"),
    "bed_roughness": dict(cmap="copper"),
}

_RHO_I, _RHO_SW = 910.0, 1028.0


def _taf(mo: MeshOutput, ti):
    Hi = mo.read("Hi", ti)
    Hb = mo.read("Hb", ti)
    SL = mo.read("SL", ti) if "SL" in mo.variables else np.zeros_like(Hi)
    return Hi - np.maximum(0.0, (SL - Hb) * _RHO_SW / _RHO_I), Hi, Hb, SL


def field_contours(mo: MeshOutput, which="grounding_line", ti=-1):
    """Contour polylines [[n,2] arrays, km] on the output mesh:
    'grounding_line' (TAF = 0 under ice), 'calving_front' /
    'ice_margin' (ice edge), 'coastline' (bedrock at sea level,
    ice-free)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri

    taf, Hi, Hb, SL = _taf(mo, ti)
    if which == "grounding_line":
        F = np.where(Hi > 0.1, taf, -1.0)
        level = 0.0
    elif which in ("calving_front", "ice_margin"):
        F = Hi
        level = 0.1
    elif which == "coastline":
        F = np.where(Hi > 0.1, 1.0, Hb - SL)
        level = 0.0
    else:
        raise ValueError(f"unknown contour '{which}'")
    tri = mtri.Triangulation(mo.V[:, 0] / 1e3, mo.V[:, 1] / 1e3, mo.Tri)
    fig, ax = plt.subplots()
    try:
        cs = ax.tricontour(tri, F, levels=[level])
        segs = [np.asarray(s) for s in cs.allsegs[0]] if cs.allsegs else []
    finally:
        plt.close(fig)
    return segs


class Figure:
    """A multi-panel figure, built panel by panel (upsy figure.py
    Figure)."""

    def __init__(self, ncols=None, panel_size=5.0):
        self.panels = []          # (title, draw_fn)
        self.ncols = ncols
        self.panel_size = panel_size

    def add_field(self, mo: MeshOutput, var, ti=-1, mask=None, **over):
        opts = dict(FIELD_DEFAULTS.get(var, {}))
        opts.update(over)
        d = mo.read(var, ti)
        if mask is not None:
            d = np.where(mask, d, np.nan)
        self.panels.append((var, mo, d, ti, opts))
        return self

    def add_diff(self, mo1, var1, mo2, var2=None, ti1=-1, ti2=-1,
                 name=None, **over):
        """Panel of (field1 - field2); both must live on the same mesh
        (upsy DiffField.check_compatibility)."""
        var2 = var2 or var1
        d1 = mo1.read(var1, ti1)
        d2 = mo2.read(var2, ti2)
        if d1.shape != d2.shape or mo1.nV != mo2.nV:
            raise ValueError("diff fields live on different meshes")
        d = d1 - d2
        opts = dict(cmap="RdBu_r", center=0)
        opts.update(over)
        self.panels.append((name or f"d({var1})", mo1, d, ti1, opts))
        return self

    def make(self, figname=None, add_gl=True, add_cf=False,
             add_time=True):
        import matplotlib
        if figname:
            matplotlib.use("Agg")
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt
        import matplotlib.tri as mtri

        n = max(len(self.panels), 1)
        nc = self.ncols or min(n, 3)
        nr = (n + nc - 1) // nc
        fig, axs = plt.subplots(nr, nc, squeeze=False,
                                figsize=(self.panel_size * nc,
                                         0.9 * self.panel_size * nr))
        for i, (title, mo, d, ti, opts) in enumerate(self.panels):
            ax = axs[i // nc][i % nc]
            tri = mtri.Triangulation(mo.V[:, 0] / 1e3, mo.V[:, 1] / 1e3,
                                     mo.Tri)
            fin = d[np.isfinite(d)]
            vmin = opts.get("vmin", fin.min() if fin.size else 0.0)
            vmax = opts.get("vmax", fin.max() if fin.size else 1.0)
            norm = None
            if opts.get("center") is not None and vmax > vmin:
                a = max(abs(vmin), abs(vmax))
                vmin, vmax = -a, a
            if opts.get("log") and vmax > 0:
                norm = mcolors.LogNorm(max(vmin, 1e-2, vmax * 1e-4), vmax)
                vmin = vmax = None
            kw = dict(cmap=opts.get("cmap", "viridis"),
                      vmin=vmin, vmax=vmax, norm=norm)
            dd = np.where(np.isfinite(d), d, 0.0)
            if d.shape[0] == mo.nV:
                pc = ax.tripcolor(tri, dd, shading="gouraud", **kw)
            else:
                pc = ax.tripcolor(tri, facecolors=dd, **kw)
            for which, on, color in (("grounding_line", add_gl, "magenta"),
                                     ("calving_front", add_cf, "cyan")):
                if on and "Hi" in mo.variables:
                    for seg in field_contours(mo, which, ti):
                        ax.plot(seg[:, 0], seg[:, 1], color=color, lw=1.0)
            t = float(mo.time[ti]) if len(mo.time) else float("nan")
            ax.set_title(f"{title} (t={t:.1f} yr)" if add_time else title)
            ax.set_aspect("equal")
            ax.set_xlabel("x [km]")
            ax.set_ylabel("y [km]")
            fig.colorbar(pc, ax=ax, shrink=0.75)
        for j in range(len(self.panels), nr * nc):
            axs[j // nc][j % nc].axis("off")
        fig.tight_layout()
        if figname:
            fig.savefig(figname, dpi=150, bbox_inches="tight")
            plt.close(fig)
            return figname
        return fig
