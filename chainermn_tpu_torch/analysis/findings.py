"""Finding/report datatypes for shardlint
(``chainermn_tpu_torch.analysis``).

Counterpart of ``chainermn_tpu/analysis/findings.py`` (a copy: it
imports no framework).  A :class:`Finding` is one rule hit: rule id,
severity, message, the lint target it fired on, and the source
location of the graph node it fired on (``walker.node_source``).  A
:class:`Report` aggregates findings across targets and renders the text
/ JSON outputs the CLI prints.
"""

import json

SEV_ERROR = 'error'
SEV_WARNING = 'warning'
SEVERITIES = (SEV_ERROR, SEV_WARNING)


class Finding:
    """One rule violation (or analyzer-level failure) on one target."""

    def __init__(self, rule_id, severity, message, target='',
                 where=None):
        if severity not in SEVERITIES:
            raise ValueError('severity must be one of %r, got %r'
                             % (SEVERITIES, severity))
        self.rule_id = rule_id
        self.severity = severity
        self.message = message
        self.target = target
        self.where = where  # "file.py:line" or None

    def as_dict(self):
        return {'rule': self.rule_id, 'severity': self.severity,
                'target': self.target, 'message': self.message,
                'where': self.where}

    def __repr__(self):
        loc = ' (%s)' % self.where if self.where else ''
        return '%s: %s %s: %s%s' % (self.target, self.severity,
                                    self.rule_id, self.message, loc)


class Report:
    """Findings across a lint sweep, plus per-target bookkeeping."""

    def __init__(self):
        self.findings = []
        self.targets = []  # names, in lint order
        # memtraffic rows (analysis.memtraffic.report):
        # per-target bytes / flops / bytes-per-item / top widest
        # intermediates; empty when the sweep skipped the audit
        self.memtraffic = []
        # cross-rank verification metadata
        # (analysis.commcheck.run_commcheck): the world sizes /
        # strategies swept, stream-trace and protocol counts,
        # pipeline-schedule compositions.  Empty when the sweep
        # skipped commcheck.
        self.commcheck = {}

    def add(self, finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def add_target(self, name):
        self.targets.append(name)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == SEV_WARNING]

    def ok(self):
        return not self.errors

    def as_dict(self):
        return {
            'tool': 'shardlint',
            'targets': list(self.targets),
            'n_targets': len(self.targets),
            'n_errors': len(self.errors),
            'n_warnings': len(self.warnings),
            'ok': self.ok(),
            'findings': [f.as_dict() for f in self.findings],
            'memtraffic': list(self.memtraffic),
            'commcheck': dict(self.commcheck),
        }

    def to_json(self, indent=None):
        return json.dumps(self.as_dict(), indent=indent, sort_keys=False)

    def render_text(self):
        lines = []
        for f in self.findings:
            lines.append(repr(f))
        for row in self.memtraffic:
            bits = []
            if row.get('bytes_accessed'):
                bits.append('%.1f MB accessed'
                            % (row['bytes_accessed'] / 1e6))
            if row.get('bytes_per_item'):
                bits.append('%.2f MB/item'
                            % (row['bytes_per_item'] / 1e6))
            if row.get('f32_materialized_count'):
                bits.append('%d f32 materializations (%.1f MB)'
                            % (row['f32_materialized_count'],
                               row['f32_materialized_bytes'] / 1e6))
            if row.get('cost_error'):
                bits.append('cost: %s' % row['cost_error'])
            if row.get('trace_error'):
                bits.append('trace: %s' % row['trace_error'])
            lines.append('memtraffic %s: %s'
                         % (row.get('target'),
                            '; '.join(bits) or 'no data'))
        if self.commcheck:
            lines.append(
                'commcheck: %d strategies x world sizes %s, '
                '%d stream traces, %d eager protocols, '
                '%d pipeline schedules, ok=%s'
                % (len(self.commcheck.get('strategies', ())),
                   self.commcheck.get('world_sizes'),
                   self.commcheck.get('n_stream_traces', 0),
                   len(self.commcheck.get('protocols', ())),
                   len(self.commcheck.get('pipeline_schedules', ())),
                   self.commcheck.get('ok')))
        lines.append('shardlint: %d target(s), %d error(s), '
                     '%d warning(s)' % (len(self.targets),
                                        len(self.errors),
                                        len(self.warnings)))
        return '\n'.join(lines)
