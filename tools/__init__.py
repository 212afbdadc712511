"""The port's card tools (run as scripts), and the table inputs that
``chip_smoke.py`` shares with them (``tools.smoke_cases``)."""
