"""upsy make_movie equivalent: render a variable across all mesh
generations and timeframes into frames and (if ffmpeg is available)
an mp4 (tools/python/upsy/run.py make_movie + main_movie.py)."""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

from .run import Run
from .figure import Figure


def make_movie(rundir, variables, framerate=10, out_dir=None,
               region=None):
    run = Run(rundir)
    out = Path(out_dir or (Path(rundir) / "movie"))
    out.mkdir(parents=True, exist_ok=True)
    frame = 0
    for m in range(run.n_meshes):
        mo = run.get_mesh(m, region=region)
        for ti in range(max(len(mo.time), 1)):
            fig = Figure(ncols=len(variables))
            for var in variables:
                fig.add_field(mo, var, ti=ti)
            fig.make(str(out / f"frame_{frame:04d}.png"))
            frame += 1
    print(f"{frame} frames in {out}")
    if shutil.which("ffmpeg"):
        name = out / ("_".join(variables) + ".mp4")
        subprocess.run(
            ["ffmpeg", "-y", "-r", str(framerate), "-f", "image2",
             "-i", str(out / "frame_%04d.png"), "-pix_fmt", "yuv420p",
             "-vcodec", "libx264", "-crf", "24", str(name)],
            check=True, capture_output=True)
        for f in out.glob("frame_*.png"):
            f.unlink()
        print(f"wrote {name}")
        return name
    print("ffmpeg not available: frames kept as PNGs")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="upsy-make-movie",
        description="Render output frames (+mp4 when ffmpeg exists)")
    p.add_argument("rundir")
    p.add_argument("variables", nargs="+")
    p.add_argument("--framerate", type=int, default=10)
    p.add_argument("--region", default=None)
    p.add_argument("-o", "--out-dir", default=None)
    args = p.parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    make_movie(args.rundir, args.variables, args.framerate,
               args.out_dir, args.region)


if __name__ == "__main__":
    main()
