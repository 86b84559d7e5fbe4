"""The summary of the card's samples: each field that the card reports,
with the fields it reports as "[N/A]" left out and malformed lines
skipped."""

from bench_port import power


class _Ended:
    def terminate(self):
        pass

    def wait(self, timeout=None):
        pass


def test_summary_skips_what_the_card_does_not_report(tmp_path):
    path = tmp_path / "power.csv"
    path.write_text("1980, [N/A], 300.5, 700.00, 40\n"
                    "1980, 2619, 310.5, 700.00, 42\n"
                    "a line cut short\n")
    log = power.PowerLog.__new__(power.PowerLog)
    log.path, log.proc = str(path), _Ended()
    log._out = open(tmp_path / "sink", "w")
    out = log.stop()
    assert out["samples"] == 2
    assert out["clocks.mem"] == [2619.0, 2619.0, 2619.0]
    assert out["power.draw"] == [300.5, 305.5, 310.5]
    assert out["temperature.gpu"] == [40.0, 41.0, 42.0]
