"""Subcommand dispatch: ``python -m photon_ml_tpu_torch <command> [args...]``
(counterpart of ``photon_ml_tpu/__main__.py``). ``train_game``,
``refresh_game``, ``train_glm``, ``score_game``, ``serve_game``,
``serve_fleet``, ``build_index`` and ``join_feedback`` are the commands;
the lint runs as ``python -m photon_ml_tpu_torch.analysis``."""

from __future__ import annotations

import sys

_COMMANDS = {
    "train_game": "photon_ml_tpu_torch.cli.train_game",
    "refresh_game": "photon_ml_tpu_torch.cli.refresh_game",
    "train_glm": "photon_ml_tpu_torch.cli.train_glm",
    "score_game": "photon_ml_tpu_torch.cli.score_game",
    "serve_game": "photon_ml_tpu_torch.cli.serve_game",
    "serve_fleet": "photon_ml_tpu_torch.cli.serve_fleet",
    "build_index": "photon_ml_tpu_torch.cli.build_index",
    "join_feedback": "photon_ml_tpu_torch.cli.join_feedback",
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _COMMANDS:
        names = ", ".join(_COMMANDS)
        print(f"usage: python -m photon_ml_tpu_torch {{{names}}} [options]\n"
              f"run a command with -h for its options")
        raise SystemExit(0 if argv and argv[0] in ("-h", "--help") else 2)
    import importlib

    command = importlib.import_module(_COMMANDS[argv[0]])
    result = command.run(argv[1:])
    if result:
        print(result)


if __name__ == "__main__":
    main()
