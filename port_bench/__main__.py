import sys

from port_bench.run import main

sys.exit(main())
