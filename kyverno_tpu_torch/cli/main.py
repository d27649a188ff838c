"""kubectl-kyverno CLI entry point.

Reference: cmd/cli/kubectl-kyverno/main.go:22 — subcommands ``apply``,
``test``, ``jp``, ``version``. Run as ``python -m kyverno_tpu.cli ...``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .. import __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='kyverno',
        description='Kyverno-TPU: batched policy evaluation for Kubernetes')
    sub = parser.add_subparsers(dest='command')

    p_apply = sub.add_parser(
        'apply', help='Apply policies to resources')
    p_apply.add_argument('paths', nargs='+', help='policy file(s) or dir(s)')
    p_apply.add_argument('--resource', '-r', action='append',
                         help='resource file path')
    p_apply.add_argument('--set', '-s', action='append',
                         help='variables key=value[,key=value]')
    p_apply.add_argument('--values-file', '-f', dest='values_file',
                         help='values file for variable substitution')
    p_apply.add_argument('--userinfo', '-u', help='admission info YAML')
    p_apply.add_argument('--policy-report', '-p', action='store_true',
                         dest='policy_report',
                         help='output a policy report')
    p_apply.add_argument('--audit-warn', action='store_true',
                         dest='audit_warn',
                         help='audit failures are warnings, not failures')
    p_apply.add_argument('--output', '-o', help='mutated resource output file')
    p_apply.add_argument('--registry', action='store_true',
                         help='allow image registry access')

    p_test = sub.add_parser(
        'test', help='Run kyverno-test.yaml fixtures')
    p_test.add_argument('paths', nargs='*', help='dirs with kyverno-test.yaml')
    p_test.add_argument('--file-name', '-f', dest='file_name',
                        default='kyverno-test.yaml',
                        help='test file name (default kyverno-test.yaml)')
    p_test.add_argument('--test-case-selector', '-t',
                        dest='test_case_selector',
                        help='filter, e.g. policy=name,rule=name,resource=x')
    p_test.add_argument('--registry', action='store_true',
                        help='allow image registry access')
    p_test.add_argument('--fail-only', action='store_true', dest='fail_only',
                        help='print only failed test cases')
    p_test.add_argument('--debug', action='store_true')

    p_jp = sub.add_parser('jp', help='JMESPath utilities')
    jp_sub = p_jp.add_subparsers(dest='jp_command')
    p_q = jp_sub.add_parser('query', help='evaluate a JMESPath query')
    p_q.add_argument('query', nargs='*', help='query expression(s)')
    p_q.add_argument('--input', '-i', help='input JSON/YAML file')
    p_q.add_argument('--query-file', '-q', action='append',
                     dest='query_file', help='read query from file')
    p_q.add_argument('--unquoted', '-u', action='store_true',
                     help='unquoted string output')
    p_p = jp_sub.add_parser('parse', help='print the parsed AST')
    p_p.add_argument('expression', nargs='*')
    p_fn = jp_sub.add_parser('function', help='list custom functions')
    p_fn.add_argument('name', nargs='*')

    p_oci = sub.add_parser(
        'oci', help='push/pull policies as OCI artifacts')
    oci_sub = p_oci.add_subparsers(dest='oci_command')
    p_push = oci_sub.add_parser('push', help='bundle policies to a ref')
    p_push.add_argument('paths', nargs='+',
                        help='policy file(s) or dir(s)')
    p_push.add_argument('--image', '-i', dest='ref', required=True,
                        help='layout-dir:tag destination ref')
    p_pull = oci_sub.add_parser('pull', help='extract policies from a ref')
    p_pull.add_argument('--image', '-i', dest='ref', required=True,
                        help='layout-dir:tag source ref')
    p_pull.add_argument('--output', '-o', help='output directory')

    sub.add_parser('version', help='print version')
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == 'apply':
        from .apply_command import command
        return command(args)
    if args.command == 'test':
        from .test_command import command
        return command(args)
    if args.command == 'jp':
        from . import jp_command
        if args.jp_command == 'query':
            return jp_command.command_query(args)
        if args.jp_command == 'parse':
            return jp_command.command_parse(args)
        if args.jp_command == 'function':
            return jp_command.command_function(args)
        print('usage: kyverno jp {query,parse,function}')
        return 1
    if args.command == 'oci':
        from . import oci_command
        if args.oci_command == 'push':
            return oci_command.command_push(args)
        if args.oci_command == 'pull':
            return oci_command.command_pull(args)
        print('usage: kyverno oci {push,pull}')
        return 1
    if args.command == 'version':
        print(f'Version: {__version__}')
        return 0
    parser.print_help()
    return 0


if __name__ == '__main__':
    sys.exit(main())
