"""Every ported subcommand parses vst's command lines: each of vst's flags
for that subcommand (read from vst's own parser, which ``vst.cli.__main__.main``
builds and hands to ``parse_args``), with a value of its own kind, is
accepted by the port's parser. ``--platform`` is left out: the port takes
``--device`` in its place."""

import argparse

import pytest

import vst.cli.__main__ as vcli
from vst_torch.cli.__main__ import parser as port_parser


class _Parser(Exception):
    pass


def _vst_parser():
    saved = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        raise _Parser(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        vcli.main([])
    except _Parser as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = saved
    raise AssertionError("vst's main never parsed")


def _subcommands(p):
    return next(a.choices for a in p._actions if isinstance(a, argparse._SubParsersAction))


VST = _subcommands(_vst_parser())
PORT = _subcommands(port_parser())
NOT_PORTED = set()  # every subcommand of vst is ported


def _argv(action):
    """One occurrence of a vst flag with a value of its kind."""
    flag = action.option_strings[-1 if action.option_strings[0].startswith("--no-") else 0]
    if action.nargs == 0:  # store_true / BooleanOptionalAction
        return [flag]
    if action.choices:
        value = [str(next(c for c in action.choices if c is not None))]
    elif action.type is int:
        value = [str(action.default if isinstance(action.default, int) else 2)]
    elif action.type is float:
        value = [str(action.default if isinstance(action.default, float) else 0.5)]
    else:
        value = [action.default if isinstance(action.default, str) else "x"]
    if action.nargs in ("+", "*"):
        value = [str(v) for v in action.default] if action.default else value
    elif isinstance(action.nargs, int):
        value = [str(v) for v in action.default]
    return [flag, *value]


def test_the_unported_subcommands_are_the_known_ones():
    assert set(VST) - set(PORT) == NOT_PORTED


@pytest.mark.parametrize("name", sorted(set(VST) - NOT_PORTED))
def test_port_parses_vsts_flags(name):
    argv = [name]
    for action in VST[name]._actions:
        if action.option_strings and action.option_strings[0] not in ("-h", "--platform"):
            argv += _argv(action)
    args = port_parser().parse_args(argv)
    assert args.command == name


@pytest.mark.parametrize("argv", [["eval-sintel", "--batch-size", "4"],
                                  ["stylize-video", "--style-dir", "D"],
                                  ["eval-fc2", "--lambda-tcl", "100"]])
def test_the_command_lines_that_exited_2_parse(argv):
    port_parser().parse_args(argv)


def test_an_unread_common_flag_says_so():
    sub = PORT["eval-sintel"]
    helps = {a.option_strings[0]: a.help for a in sub._actions if a.option_strings}
    assert "does not read" in helps["--steps"]
    assert "does not read" not in (helps.get("--dt-iters") or "")
    train = {a.option_strings[0]: a.help for a in PORT["train-faststyle"]._actions
             if a.option_strings}
    assert "does not read" not in train["--steps"]
