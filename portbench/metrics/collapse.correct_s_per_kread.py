"""Host seconds inside ``pipeline.collapse.correct_reads`` (the cluster
threads' correction and consensus; a span around each call, summed) over
the window's thousands of input reads."""

SPANS = {'collapse.correct_reads': ('ciri_long_tpu_torch.pipeline.collapse',
                                    'correct_reads')}


def read(rec):
    sec = rec['spans'].get('collapse.correct_reads')
    if rec['entry'] == 'collapse' and sec and rec['reads']:
        return sec / (rec['reads'] / 1000)
