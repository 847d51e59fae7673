"""Drivers: one module per path of the program, named by a configuration's `driver`.

A driver module defines `Driver(config, traffic, seed, device)` with

    libraries                 the program's CUDA libraries the path launches
    contributions_per_epoch   contributions one committed epoch commits
    setup()                   inputs from the seed, the system built on them,
                              every shape warmed up
    step() -> bool            one committed epoch through the program's entry;
                              returns the epoch's own verdict, read on the host
    collect()                 the program's outputs copied to the host, its
                              state freed
    check() -> [(name, value, limit)]
                              the outputs against the plain reference

(`setup()` is `make_inputs()`, `build_system()` and the warm epochs), and
`Control(driver)`, the reference in the program's place with one of the
configuration's guarantees broken (benchmark/control.py runs it).
"""
