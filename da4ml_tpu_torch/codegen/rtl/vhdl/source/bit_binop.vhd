-- Bitwise binary op (DAIS opcode 10): o = ((+/-a) << SHA) OP ((+/-b) << SHB),
-- OP in {AND=0, OR=1, XOR=2}, over two's-complement WO bits.
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity bit_binop is
    generic (
        WA : integer := 8;
        SA : integer := 1;
        WB : integer := 8;
        SB : integer := 1;
        NEG_A : integer := 0;
        NEG_B : integer := 0;
        SHA : integer := 0;
        SHB : integer := 0;
        OP : integer := 0;
        WO : integer := 8
    );
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        b : in std_logic_vector(WB - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of bit_binop is
    constant WI : integer := imax(WA + SHA, WB + SHB) + 2;
    signal ea0, eb0, ea, eb, r : signed(WI - 1 downto 0);
begin
    ea0 <= ext(a, SA, WI);
    eb0 <= ext(b, SB, WI);
    ea <= shift_left(-ea0, SHA) when NEG_A = 1 else shift_left(ea0, SHA);
    eb <= shift_left(-eb0, SHB) when NEG_B = 1 else shift_left(eb0, SHB);
    r <= (ea and eb) when OP = 0 else (ea or eb) when OP = 1 else (ea xor eb);
    o <= std_logic_vector(r(WO - 1 downto 0));
end architecture;
