"""The sort-join engine: record build, round sort, judge, host tail."""
