"""MovieGraphs pickle/JSON explorer — the reference's py3loader demo
(ref moviegraphs/py3loader/startup.py): load the graphs, print the movie
census, a cast list, and one clip-graph summary. Works on either the
``mg3``-style pickle (torch-free restricted unpickling) or a directory of
per-movie JSON dumps. A copy of lirec_tpu/cli/graphs_demo.py over the
port's data/graphs.py."""

from __future__ import annotations

import argparse
import sys

from lirec_tpu_torch.data import graphs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", help="mg3-style .pkl or a directory of "
                                "<movie>.json clip-graph dumps")
    p.add_argument("--movie", default="",
                   help="imdb key to inspect (default: first movie)")
    p.add_argument("--clip", type=int, default=None,
                   help="clip index to pprint (default: first clip)")
    args = p.parse_args(argv)

    movies = graphs.load_graphs(args.path)
    print("Found %d movies with graphs" % len(movies))
    if not movies:
        print("no movie graphs found under %r" % args.path, file=sys.stderr)
        return 1

    key = args.movie or next(iter(movies))
    if key not in movies:
        print("movie %r not in the dump (have: %s ...)"
              % (key, ", ".join(list(movies)[:5])), file=sys.stderr)
        return 1
    mg = movies[key]
    print("Selected movie: %s" % mg.imdb_key)
    print()
    print("Cast in this movie:")
    for character in getattr(mg, "castlist", None) or ():
        print(character.get("chid"), character.get("name"))

    print()
    print("Selected one clip graph")
    clip_ids = sorted(mg.clip_graphs)
    if not clip_ids:
        print("movie %s has no clip graphs" % mg.imdb_key, file=sys.stderr)
        return 1
    cid = args.clip if args.clip is not None else clip_ids[0]
    if cid not in mg.clip_graphs:
        print("clip %r not in movie (have: %s)" % (cid, clip_ids[:10]),
              file=sys.stderr)
        return 1
    mg.clip_graphs[cid].pprint()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
