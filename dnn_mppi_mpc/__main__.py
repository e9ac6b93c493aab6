"""``python -m dnn_mppi_mpc`` — see cli.py."""

from .cli import main

if __name__ == "__main__":
    main()
